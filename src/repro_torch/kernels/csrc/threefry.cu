// Threefry-2x32 draws over one block of a tensor, bit for bit as jax.random
// draws them under its partitionable counter layout.
//
// Replaces no TPU kernel: the reference draws its LM parameters with XLA
// ops (`jax.random.normal` / `uniform` in src/repro/models/model.py,
// `init_params` and `_dense`).  It is here so that a fresh start draws the
// reference's parameters from the same seed on the card, and so that a rank
// draws only the block of a leaf it holds: element i of a draw hashes only
// its own counter, the global flat index i as the pair (i >> 32,
// i & 0xFFFFFFFF), and keeps the xor of the two output words.
//
// Modes: 0 the raw 32-bit words; 1 uniform(lo, hi): the top 23 bits under
// the exponent of 1.0, minus 1, times (hi - lo) plus lo in one rounding (the
// FMA that XLA:CPU makes of JAX's jitted `_uniform`), floored at lo;
// 2 sqrt(2) * erf_inv(uniform(lo, hi)) * scale, `jax.random.normal` times a
// float32 scale when lo = nextafter(-1, 0) and hi = 1.  erf_inv is Giles'
// single-precision form as XLA lowers `chlo.erf_inv`: w = -log1p(-x*x); a
// 9-term polynomial in w - 2.5 if w < 5, else in sqrt(w) - 3; times x; +-inf
// at x = +-1.  log1p is XLA:CPU's own (its Cephes logf and rational
// function), not the card's log1pf, and the FMAs are where XLA:CPU's
// compiler forms them (__fmaf_rn); built with --fmad=false, every other
// product and sum rounds on its own, and divide and sqrt are IEEE.  So the
// kernel computes what the plain version and JAX's eager draws on the CPU
// compute, bit for bit.
//
// What bounds it on an H100: it reads nothing and writes 4 bytes an
// element, so the bytes bound is n * 4 / 3.35 TB/s; its ~100 integer
// operations of the 20 rounds an element (and ~60 float operations of a
// normal) may well cost more than that.  A block is up to 4 dimensions of a
// leaf of up to 4; one thread takes one element at a time, in a grid-stride
// loop, and recovers the element's global index from its block coordinates.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kDims = 4;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

struct Dims {
  long long d[kDims];
};

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// The 20-round block function on the counter pair (x0, x1); the xor of the
// two output words.
__device__ __forceinline__ unsigned threefry_xor(unsigned k0, unsigned k1, unsigned x0,
                                                 unsigned x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_ROUND

__device__ __forceinline__ float uniform_of(unsigned bits, float lo, float span) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(lo, __fmaf_rn(f, span, lo));
}

// XLA:CPU's float32 log (Cephes' logf, with the FMAs its compiler forms),
// for y > 0; -inf at 0, inf at inf, NaN below 0.
__device__ __forceinline__ float log_xla(float y) {
  const unsigned bits = __float_as_uint(fmaxf(y, 1.17549435e-38f));
  const float m = __uint_as_float((bits & 0x7FFFFFu) | 0x3F000000u);
  float ef = static_cast<float>(static_cast<int>(bits >> 23) - 127) + 1.0f;
  float x = m - 1.0f;
  if (m < __uint_as_float(0x3F3504F3u)) {  // sqrt(1/2)
    ef = ef - 1.0f;
    x = x + m;
  }
  const float z = x * x;
  const float x3 = z * x;
  float a = __fmaf_rn(x, __uint_as_float(0x3D9021BBu), __uint_as_float(0xBDEBD1B8u));
  a = __fmaf_rn(x, a, __uint_as_float(0x3DEF251Au));
  float b = __fmaf_rn(x, __uint_as_float(0xBDFE5D4Fu), __uint_as_float(0x3E11E9BFu));
  b = __fmaf_rn(x, b, __uint_as_float(0xBE2AAE50u));
  float c = __fmaf_rn(x, __uint_as_float(0x3E4CCEACu), __uint_as_float(0xBE7FFFFCu));
  c = __fmaf_rn(x, c, __uint_as_float(0x3EAAAAAAu));
  const float poly = __fmaf_rn(x3, __fmaf_rn(x3, a, b), c);
  float r = __fmaf_rn(-0.5f, z, x) + __fmaf_rn(x3, poly, ef * __uint_as_float(0xB95E8083u));
  r = __fmaf_rn(ef, __uint_as_float(0x3F318000u), r);  // ln 2 = 0.693359375 - 2.12e-4
  if (y == INFINITY) return INFINITY;
  if (y == 0.0f) return -INFINITY;
  return y > 0.0f ? r : NAN;
}

// XLA:CPU's float32 log1p: log(1 + x), and below |x| = sqrt(2) - 1 the
// Cephes rational function x - x^2 / 2 + x^3 P(x) / Q(x).
__device__ __forceinline__ float log1p_xla(float x) {
  if (!(fabsf(x) < __uint_as_float(0x3ED413CDu))) return log_xla(x + 1.0f);
  const float x2 = x * x;
  float den = 1.0f;
  den = __fmaf_rn(x, den, __uint_as_float(0x417101ADu));
  den = __fmaf_rn(x, den, __uint_as_float(0x42A6185Bu));
  den = __fmaf_rn(x, den, __uint_as_float(0x435DC32Du));
  den = __fmaf_rn(x, den, __uint_as_float(0x439A8CA3u));
  den = __fmaf_rn(x, den, __uint_as_float(0x43586D8Au));
  den = __fmaf_rn(x, den, __uint_as_float(0x42707982u));
  float num = __uint_as_float(0x383DE04Bu);
  num = __fmaf_rn(x, num, __uint_as_float(0x3EFF40C5u));
  num = __fmaf_rn(x, num, __uint_as_float(0x40D284FAu));
  num = __fmaf_rn(x, num, __uint_as_float(0x41EF4B9Cu));
  num = __fmaf_rn(x, num, __uint_as_float(0x4273CC76u));
  num = __fmaf_rn(x, num, __uint_as_float(0x426473ADu));
  num = __fmaf_rn(x, num, __uint_as_float(0x41A05101u));
  return x + __fmaf_rn(-0.5f, x2, (x * x2) * __fdiv_rn(num, den));
}

// XLA:CPU's chlo.erf_inv (Giles), every step of its polynomial an FMA.
__device__ __forceinline__ float erf_inv(float x) {
  const float lg = log1p_xla(x * -x);
  float w, p;
  if (lg > -5.0f) {  // w = -lg < 5
    w = -2.5f - lg;
    p = __fmaf_rn(w, 2.81022636e-08f, 3.43273939e-07f);
    p = __fmaf_rn(w, p, -3.5233877e-06f);
    p = __fmaf_rn(w, p, -4.39150654e-06f);
    p = __fmaf_rn(w, p, 0.00021858087f);
    p = __fmaf_rn(w, p, -0.00125372503f);
    p = __fmaf_rn(w, p, -0.00417768164f);
    p = __fmaf_rn(w, p, 0.246640727f);
    p = __fmaf_rn(w, p, 1.50140941f);
  } else {
    w = __fsqrt_rn(-lg) - 3.0f;
    p = __fmaf_rn(w, -0.000200214257f, 0.000100950558f);
    p = __fmaf_rn(w, p, 0.00134934322f);
    p = __fmaf_rn(w, p, -0.00367342844f);
    p = __fmaf_rn(w, p, 0.00573950773f);
    p = __fmaf_rn(w, p, -0.0076224613f);
    p = __fmaf_rn(w, p, 0.00943887047f);
    p = __fmaf_rn(w, p, 1.00167406f);
    p = __fmaf_rn(w, p, 2.83297682f);
  }
  return x * (fabsf(x) == 1.0f ? INFINITY : p);
}

__global__ void __launch_bounds__(kThreads)
    threefry_kernel(unsigned k0, unsigned k1, Dims shape, Dims start, Dims len, long long n,
                    int mode, float lo, float span, float scale, unsigned* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < n;
       j += stride) {
    // the block coordinates of local element j, then its global flat index
    long long c[kDims], r = j;
#pragma unroll
    for (int d = kDims - 1; d > 0; --d) {
      c[d] = r % len.d[d];
      r /= len.d[d];
    }
    c[0] = r;
    long long g = 0;
#pragma unroll
    for (int d = 0; d < kDims; ++d) g = g * shape.d[d] + start.d[d] + c[d];
    const unsigned long long u = static_cast<unsigned long long>(g);
    const unsigned bits = threefry_xor(k0, k1, static_cast<unsigned>(u >> 32),
                                       static_cast<unsigned>(u & 0xFFFFFFFFull));
    if (mode == 0) {
      out[j] = bits;
    } else if (mode == 1) {
      out[j] = __float_as_uint(uniform_of(bits, lo, span));
    } else {
      const float z = 1.41421356237309504880f * erf_inv(uniform_of(bits, lo, span));
      out[j] = __float_as_uint(z * scale);
    }
  }
}

}  // namespace

// key (k0, k1); the tensor's shape and the block's start and length in each
// of its ndim <= 4 dimensions; mode 0 bits, 1 uniform, 2 normal * scale.
// out: the block's n = prod(length) 4-byte words, row-major.  Returns a
// cudaError_t.
extern "C" int threefry_launch(unsigned k0, unsigned k1, int ndim, const long long* shape,
                               const long long* start, const long long* length, int mode,
                               float lo, float hi, float scale, unsigned* out,
                               cudaStream_t stream) {
  if (ndim < 0 || ndim > kDims || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims g, s, l;
  long long n = 1;
  const int pad = kDims - ndim;
  for (int d = 0; d < kDims; ++d) {
    const bool real = d >= pad;
    g.d[d] = real ? shape[d - pad] : 1;
    s.d[d] = real ? start[d - pad] : 0;
    l.d[d] = real ? length[d - pad] : 1;
    if (s.d[d] < 0 || l.d[d] < 0 || s.d[d] + l.d[d] > g.d[d])
      return static_cast<int>(cudaErrorInvalidValue);
    n *= l.d[d];
  }
  if (n == 0) return 0;
  const float span = hi - lo;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  threefry_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      k0, k1, g, s, l, n, mode, lo, span, scale, out);
  return static_cast<int>(cudaGetLastError());
}
