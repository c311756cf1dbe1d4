"""Builds the package's CUDA kernels at first use and loads them.

Each ``csrc/*.cu`` file has a plain C interface.  ``nvcc`` compiles every
source to an object at once, in parallel, then links them into one shared
library that ``ctypes`` loads.  The library is keyed by a hash of the sources
and the flags, under ``build/`` at the repository root, so a second process
reuses it.  Importing this module builds nothing.

Flags: ``--fmad=false`` keeps ``a*b - c`` as a rounded product and a rounded
difference (the reference never contracts ``(laser - ring) - j*fsr``), and
division stays IEEE round-to-nearest (``-prec-div=true``; no fast math).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("feasibility.cu", "table_build.cu", "match.cu", "bottleneck.cu",
           "probe.cu", "threefry.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "librepro_torch_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "--fmad=false", "-prec-div=true",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` or PyTorch's CUDA home."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    from torch.utils.cpp_extension import CUDA_HOME

    homes.append(CUDA_HOME)
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME; the CUDA toolkit is "
        "needed to build the repro_torch kernels"
    )


def compile_commands(nvcc: str, out_dir: Path) -> list[list[str]]:
    """One ``nvcc -c`` command line per source, writing objects to ``out_dir``."""
    return [
        [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(out_dir / f"{src}.o")]
        for src in SOURCES
    ]


def link_command(nvcc: str, out_dir: Path) -> list[str]:
    objects = [str(out_dir / f"{src}.o") for src in SOURCES]
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME), *objects]


def source_key() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with the compiler's output on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(logs[-1])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "\n".join(logs)


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = BUILD_DIR / f"kernels-{source_key()}"
    lib = out / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    tmp = BUILD_DIR / f"{out.name}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    log = _run_all(compile_commands(nvcc, tmp))
    log += "\n" + _run_all([link_command(nvcc, tmp)])
    (tmp / "build.log").write_text(log)
    try:
        tmp.rename(out)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the build."""
    return (build().parent / "build.log").read_text()


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U, _F, _LLP = ctypes.c_uint, ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.feasibility_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P]
    lib.feasibility_launch.restype = _I
    lib.table_build_launch.argtypes = [
        _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P, _P, _P, _P,
    ]
    lib.table_build_launch.restype = _I
    lib.match_launch.argtypes = [_P, _I, _I, _P, _P, _P]
    lib.match_launch.restype = _I
    lib.bottleneck_launch.argtypes = [_P, _I, _I, _P, _P]
    lib.bottleneck_launch.restype = _I
    lib.probe_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.probe_launch.restype = _I
    lib.threefry_launch.argtypes = [_U, _U, _I, _LLP, _LLP, _LLP, _I, _F, _F, _F, _P, _P]
    lib.threefry_launch.restype = _I
    return lib


#: The most trials a launch takes: every launch function takes T as an
#: ``int`` and rounds it up to whole blocks in ``int`` arithmetic (offsets
#: into the (T, N) and (T, N, E) arrays are ``long long`` in the kernels).
MAX_TRIALS = 2 ** 31 - 2 ** 16


def check_trials(name: str, t: int) -> None:
    """Raise if T trials would not fit a launch's ``int`` trial count."""
    if t > MAX_TRIALS:
        raise ValueError(f"{name}: {t} trials in one launch; at most {MAX_TRIALS} "
                         "(split the batch)")


def check_inputs(name: str, args, max_n: int, dtype=torch.float32,
                 square: bool = False) -> tuple[int, int]:
    """Validate a wrapper's (T, N) inputs, or (T, N, N) ones if ``square``:
    one CUDA device, one dtype, one shape, contiguous, 1 <= N <= max_n,
    T <= ``MAX_TRIALS``.  Returns (T, N)."""
    shape, dev = args[0].shape, args[0].device
    if len(shape) >= 2 and not 1 <= shape[1] <= max_n:
        raise ValueError(f"{name}: N must be in [1, {max_n}], got {shape[1]}")
    if len(shape) >= 1:
        check_trials(name, shape[0])
    for a in args:
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"{name}: all inputs must lie on one CUDA device")
        if a.dtype != dtype:
            raise TypeError(f"{name}: inputs must be {dtype}, got {a.dtype}")
        if a.dim() != (3 if square else 2) or a.shape != shape \
                or (square and shape[2] != shape[1]):
            want = "(T, N, N)" if square else "(T, N)"
            raise ValueError(f"{name}: inputs must share one {want} shape, got "
                             f"{[tuple(x.shape) for x in args]}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return shape[0], shape[1]


def check(err: int, name: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
