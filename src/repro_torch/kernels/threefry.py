"""Threefry-2x32 draws over one block of a tensor, as ``jax.random`` draws them.

Under JAX's default counter layout (``jax_threefry_partitionable=True``)
element i of a draw of ``shape`` hashes only its own counter: the global
flat index i, as the pair ``(i >> 32, i & 0xFFFFFFFF)``, through
``threefry_2x32`` (``core/prng.py``), keeping the xor of the two output
words.  So any block of the tensor, given by its start and length in each
dimension, can be drawn alone and equals that slice of the whole draw: a
rank draws only the block it holds.

``threefry_draw`` launches the CUDA kernel (``csrc/threefry.cu``) for a
CUDA ``out`` and runs ``threefry_plain`` (the rounds of
``core/prng.py::threefry_2x32`` in numpy, the float steps in torch) for a
CPU one.  Modes:

* ``BITS``: the 32-bit words (``jax.random.bits``), held in int32;
* ``UNIFORM``: ``jax.random.uniform(key, shape, float32, lo, hi)``, its
  ``floats * (hi - lo) + lo`` in one rounding, as XLA:CPU fuses it;
* ``NORMAL``: ``jax.random.normal(key, shape, float32) * scale``, i.e.
  ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))`` times a float32 scale.

Raw words and uniforms equal JAX's bit for bit.  ``erf_inv`` is Giles'
single-precision form as XLA lowers ``chlo.erf_inv``, computed as XLA:CPU
computes it: its own ``log1p`` (a Cephes ``logf`` and rational function)
and an FMA wherever its compiler forms one, as read off the x86-64 object
code of jax 0.9.0's jitted ``erf_inv``.  So normals equal JAX's eager draws
on the CPU (held within 2 ulp, ``tests/test_torch_init.py``), and the
kernel, which runs the same steps with ``__fmaf_rn``, equals the plain
version.  The reference draws with XLA ops: this kernel replaces no TPU
kernel.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core import prng
from . import _build

BITS, UNIFORM, NORMAL = 0, 1, 2
MAX_DIMS = 4
_MASK = 0xFFFFFFFF
#: Counters a piece of the plain version (torch's parallel grain size).
_PIECE = 32768
#: ``jax.random.normal``'s uniform range: (nextafter(-1, 0), 1).
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
NORMAL_HI = 1.0
_SQRT2 = float(np.float32(np.sqrt(2)))


def _bits32(*words: int) -> tuple:
    """float32 constants given by their bit patterns, as Python floats."""
    return tuple(float(np.uint32(w).view(np.float32)) for w in words)


# XLA's erf_inv coefficients (Giles), for w < 5 and for w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA:CPU's float32 log (Cephes' logf): sqrt(1/2), the three groups of its
# polynomial, and ln 2 split in two
_SQRT_HALF, = _bits32(0x3F3504F3)
_LOG_A = _bits32(0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A)
_LOG_B = _bits32(0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50)
_LOG_C = _bits32(0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_LN2_LO, _LN2_HI = _bits32(0xB95E8083, 0x3F318000)
# XLA's log1p: below |x| = sqrt(2) - 1 a Cephes rational function
_LOG1P_SMALL, = _bits32(0x3ED413CD)
_LOG1P_DEN = _bits32(0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982)
_LOG1P_NUM = _bits32(0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
                     0x41A05101)


def _block(shape, start=None, length=None) -> tuple[tuple, tuple, tuple]:
    """``(shape, start, length)`` as int tuples: the whole tensor by
    default; raises unless the block lies inside ``shape`` (at most
    ``MAX_DIMS`` dimensions)."""
    shape = tuple(int(d) for d in shape)
    start = (0,) * len(shape) if start is None else tuple(int(s) for s in start)
    length = tuple(d - s for d, s in zip(shape, start)) if length is None \
        else tuple(int(n) for n in length)
    if len(shape) > MAX_DIMS or not len(start) == len(length) == len(shape):
        raise ValueError(f"threefry: a block of at most {MAX_DIMS} dimensions, got shape "
                         f"{shape}, start {start}, length {length}")
    if any(s < 0 or n < 0 or s + n > d for d, s, n in zip(shape, start, length)):
        raise ValueError(f"threefry: block start {start} length {length} outside {shape}")
    return shape, start, length


def _key_words(key) -> tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"threefry: a key is two uint32 words, got shape {k.shape}")
    return int(k[0]), int(k[1])


def _counters(shape, start, length) -> torch.Tensor:
    """int64 global flat indices of the block, in its own shape."""
    idx = torch.zeros((1,) * len(shape), dtype=torch.int64)
    for d, (g, s, n) in enumerate(zip(shape, start, length)):
        col = torch.arange(s, s + n, dtype=torch.int64)
        idx = idx * g + col.view((1,) * d + (n,) + (1,) * (len(shape) - d - 1))
    return idx.reshape(length)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _uniform(bits: np.ndarray, lo: float, hi: float) -> torch.Tensor:
    """float32 [lo, hi) from uint32 words: ``floats * (hi - lo) + lo`` in one
    rounding, as XLA:CPU fuses JAX's jitted ``_uniform`` into an FMA."""
    one = torch.from_numpy(((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32))
    floats = one - 1.0
    lo32, hi32 = _f32(lo), _f32(hi)
    return torch.maximum(lo32, fma32(floats, float(hi32 - lo32), float(lo32)))


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as an FMA instruction gives it
    (tensors or Python floats, each a float32 value).  In float64 the
    product of two float32 values is exact and the sum is rounded once
    more; where that double rounding lands on a float32 tie (the low 29
    bits of the double exactly half; results in float32's normal range),
    the sum's error term (TwoSum) says which way the exact value lies."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x for x in (a, b, c))
    p = a * b
    r = p + c
    f = r.float()
    tie = r.view(torch.int64).bitwise_and(0x1FFFFFFF) == 0x10000000
    if not bool(tie.any()):
        return f
    pb = r - p
    err = (p - (r - pb)) + (c - pb)
    toward = torch.nextafter(r, torch.where(err > 0, math.inf, -math.inf).double())
    return torch.where(tie & (err != 0), toward.float(), f)


def log_plain(y: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA:CPU computes it (its Cephes ``logf``, with the
    FMAs its compiler forms), for y > 0; -inf at 0, inf at inf, NaN below 0."""
    bits = torch.clamp_min(y, 2.0 ** -126).view(torch.int32)
    m = bits.bitwise_and(0x7FFFFF).bitwise_or_(0x3F000000).view(torch.float32)
    ef = (bits.bitwise_right_shift(23) - 127).float() + 1.0
    low = m < _SQRT_HALF
    ef = torch.where(low, ef - 1.0, ef)
    x = (m - 1.0) + torch.where(low, m, torch.zeros((), dtype=torch.float32))
    z = x * x
    x3 = z * x
    a = fma32(x, fma32(x, _LOG_A[0], _LOG_A[1]), _LOG_A[2])
    b = fma32(x, fma32(x, _LOG_B[0], _LOG_B[1]), _LOG_B[2])
    c = fma32(x, fma32(x, _LOG_C[0], _LOG_C[1]), _LOG_C[2])
    poly = fma32(x3, fma32(x3, a, b), c)
    r = fma32(-0.5, z, x) + fma32(x3, poly, ef * _LN2_LO)
    r = fma32(ef, _LN2_HI, r)
    r = torch.where(y == math.inf, math.inf, r)
    return torch.where(y == 0, -math.inf, torch.where(y > 0, r, math.nan))


def log1p_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA:CPU computes it: ``log(1 + x)``, and below
    |x| = sqrt(2) - 1 ``x - x**2 / 2 + x**3 * P(x) / Q(x)`` (Cephes)."""
    x2 = x * x
    den = torch.ones_like(x)
    for k in _LOG1P_DEN:
        den = fma32(x, den, k)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for k in _LOG1P_NUM[1:]:
        num = fma32(x, num, k)
    # float32 division and sqrt from float64 are correctly rounded (torch's
    # float32 sqrt on the CPU is not)
    small = x + fma32(-0.5, x2, (x * x2) * (num.double() / den.double()).float())
    return torch.where(x.abs() < _LOG1P_SMALL, small, log_plain(x + 1.0))


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` as XLA:CPU computes ``chlo.erf_inv`` (Giles), bit
    for bit: every step of the polynomial an FMA."""
    lg = log1p_plain(x * -x)
    small = lg > -5.0
    w = torch.where(small, -2.5 - lg, torch.sqrt(-lg.double()).float() - 3.0)
    p = torch.where(small, _f32(_ERFINV_SMALL[0]), _f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = fma32(w, p, torch.where(small, _f32(a), _f32(b)))
    return x * torch.where(x.abs() == 1.0, math.inf, p)


def _draw_words(key, idx: torch.Tensor, mode: int, lo: float, hi: float,
                scale: float) -> torch.Tensor:
    """The draws of the int64 counters ``idx``: each hashed as the pair
    ``(i >> 32, i & 0xFFFFFFFF)``, the two output words xor-ed."""
    i = idx.numpy()
    y0, y1 = prng.threefry_2x32(key, (i >> 32).astype(np.uint32),
                                (i & _MASK).astype(np.uint32))
    bits = y0 ^ y1
    if mode == BITS:
        return torch.from_numpy(bits.view(np.int32))
    u = _uniform(bits, lo, hi)
    if mode == UNIFORM:
        return u
    return erf_inv_plain(u).mul_(_f32(_SQRT2)).mul_(_f32(scale))


def threefry_plain(key, shape, start=None, length=None, *, mode: int = BITS,
                   lo: float = 0.0, hi: float = 1.0, scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version on the CPU: the block's draws, int32 words for
    ``BITS``, else float32.  The block goes in pieces of ``_PIECE``
    counters: every temporary is at most the block's size, and each of the
    hundreds of small ops a piece takes runs on one thread (torch splits
    larger ones over its thread pool, whose start and stop cost more than
    such an op when several processes share the cores)."""
    if mode not in (BITS, UNIFORM, NORMAL):
        raise ValueError(f"threefry: unknown mode {mode}")
    shape, start, length = _block(shape, start, length)
    key = np.array(_key_words(key), dtype=np.uint32)
    idx = _counters(shape, start, length).reshape(-1)
    out = torch.empty(idx.shape, dtype=torch.int32 if mode == BITS else torch.float32)
    for a in range(0, idx.numel(), _PIECE):
        out[a:a + _PIECE] = _draw_words(key, idx[a:a + _PIECE], mode, lo, hi, scale)
    return out.reshape(length)


def threefry_draw(out: torch.Tensor, key, shape, start=None, *, mode: int = BITS,
                  lo: float = 0.0, hi: float = 1.0, scale: float = 1.0) -> torch.Tensor:
    """Fill ``out`` (the block's shape, contiguous; int32 for ``BITS``, else
    float32) with the draws of the block of ``shape`` at ``start`` under
    ``key`` (two uint32 words).  A CPU ``out`` takes the plain version; a
    CUDA one launches the kernel.  Returns ``out``."""
    shape, start, length = _block(shape, start, tuple(out.shape))
    want = torch.int32 if mode == BITS else torch.float32
    if out.dtype != want:
        raise TypeError(f"threefry: mode {mode} fills {want}, got {out.dtype}")
    if out.device.type == "cpu":
        return out.copy_(threefry_plain(key, shape, start, length, mode=mode, lo=lo, hi=hi,
                                        scale=scale))
    if out.device.type != "cuda" or not out.is_contiguous():
        raise ValueError("threefry: out must be a contiguous CPU or CUDA tensor")
    if mode not in (BITS, UNIFORM, NORMAL):
        raise ValueError(f"threefry: unknown mode {mode}")
    if out.numel() == 0:
        return out
    k0, k1 = _key_words(key)
    dims = ctypes.c_longlong * max(len(shape), 1)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().threefry_launch(
            k0, k1, len(shape), dims(*shape), dims(*start), dims(*length), mode,
            lo, hi, scale, out.data_ptr(), stream)
    _build.check(err, "threefry")
    threefry_draw.launches += 1
    return out


threefry_draw.launches = 0

