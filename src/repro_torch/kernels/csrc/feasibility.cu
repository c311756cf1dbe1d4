// Ideal LtD / LtC feasibility: per-trial minimum mean tuning range.
//
// Replaces the Pallas TPU kernel `_feasibility_kernel` (feasibility_pallas)
// in src/repro/kernels/feasibility.py.  For each trial:
//   residual[i][k] = ((laser_k - ring_i) mod fsr_i) / tr_unit_i
//   ltd = max_i residual[i][s_i]
//   ltc = min over cyclic shifts c of max_i residual[i][(s_i + c) mod N]
//
// The residual is `torch.remainder` / `jnp.mod` exactly: fmodf plus fsr when
// the remainder is nonzero and its sign differs from fsr, then an IEEE
// divide (the TPU kernel's d - fsr*floor(d/fsr) times 1/tr_unit rounds
// differently near multiples of the FSR).  Built with --fmad=false and
// without fast math, so the result equals the plain version bit for bit.
// NaN propagates as in amax / amin: a shift's max is the first NaN residual
// if it has one, and ltc the first NaN shift if there is one; otherwise each
// is the first value attaining the max / min.
//
// What bounds it on an H100: the N^2 residuals of a trial, each an fmodf and
// a divide, and the latency of one launch.  A trial reads 4*N floats and
// writes two: at N = 32 and 10,000 trials 5.1 MB, about 1.6 us at 3.35 TB/s.
// Here a group of G lanes takes one trial, G = 8, 16, 32 for N <= 8, 16, 32
// (a warp takes 32 / G trials), and one warp with two shifts a lane for
// N <= 64.  The warp stages its trials' four rows and s in shared memory
// with coalesced loads.  Lane c computes req_c = max_i residual[i][(s_i + c)
// mod N] over the rings: ring[i], fsr[i], tr_unit[i] and s[i] are broadcast
// reads, laser[(s_i + c) mod N] a gather from distinct banks.  Each of the
// N^2 residuals is computed once a trial.  ltd is req_0; ltc is the group's
// least req_c by a reduction over order-preserving keys (NaN first, -0 and
// +0 one key, then the shift index), its first shift from a ballot and
// __ffs.  A warp past the ragged trial edge returns whole; a group past it
// returns after the warp's staging.  Only warp-level barriers are used.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float scaled_residual(float laser, float ring, float fsr,
                                                 float tr_unit) {
  float m = fmodf(laser - ring, fsr);
  if (m != 0.0f && ((m < 0.0f) != (fsr < 0.0f))) m += fsr;
  return m / tr_unit;
}

// NaN first, then float order (-0 and +0 one key): a reduction to the least
// key and its first shift is amin's first NaN or first least value.
__device__ __forceinline__ unsigned min_key(float x) {
  if (isnan(x)) return 0u;
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;  // -0 -> +0: they compare equal
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a[slot] with the slot chosen by compares, so the array stays in registers.
template <int L, typename T>
__device__ __forceinline__ T pick(const T (&a)[L], int slot) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < L; ++j)
    if (slot == j) v = a[j];
  return v;
}

// The group's least key, and in `first` the first index holding it.  Lane
// gl of the group holds the keys of indices gl + j * G; base is the group's
// first lane in the warp.
template <int G, int L>
__device__ __forceinline__ unsigned group_first_min(const unsigned (&key)[L],
                                                    unsigned gmask, int base,
                                                    int& first) {
  unsigned m = key[0];
#pragma unroll
  for (int j = 1; j < L; ++j) m = min(m, key[j]);
  if constexpr (G == 32) {
    m = __reduce_min_sync(kFull, m);
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(gmask, m, off, G));
  }
  first = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const unsigned hit = __ballot_sync(gmask, key[j] == m) & gmask;
    if (hit != 0u) {
      first = __ffs(hit) - 1 - base + j * G;
      break;
    }
  }
  return m;
}

template <int G, int L>
__global__ void __launch_bounds__(kThreads)
feasibility_kernel(const float* __restrict__ laser, const float* __restrict__ ring,
                   const float* __restrict__ fsr, const float* __restrict__ tr_unit,
                   const int* __restrict__ s, int n_trials, int n,
                   float* __restrict__ ltd, float* __restrict__ ltc) {
  constexpr int kTrialsPerWarp = 32 / G;
  constexpr int kWarps = kThreads / 32;
  constexpr int kSpan = kTrialsPerWarp * G * L;  // row floats a warp
  __shared__ float rows_sh[kWarps][4][kSpan];
  __shared__ int s_sh[kWarps][G * L];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % G;
  const int grp = lane / G;
  const int base = lane - gl;
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kTrialsPerWarp;
  if (t0 >= n_trials) return;  // the whole warp
  const long long left = n_trials - t0;  // trials from the warp's first on
  const int n_here = left < kTrialsPerWarp ? static_cast<int>(left) : kTrialsPerWarp;

  // Stage the warp's trials: their rows are one contiguous span per input.
  const long long off = t0 * n;
  for (int f = lane; f < n_here * n; f += 32) {
    rows_sh[warp][0][f] = laser[off + f];
    rows_sh[warp][1][f] = ring[off + f];
    rows_sh[warp][2][f] = fsr[off + f];
    rows_sh[warp][3][f] = tr_unit[off + f];
  }
  for (int i = lane; i < n; i += 32) s_sh[warp][i] = s[i];
  __syncwarp();
  if (grp >= n_here) return;  // a group past the ragged edge

  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << base;
  const float* lz = rows_sh[warp][0] + grp * n;
  const float* rg = rows_sh[warp][1] + grp * n;
  const float* fs = rows_sh[warp][2] + grp * n;
  const float* tu = rows_sh[warp][3] + grp * n;
  const int* sv = s_sh[warp];

  float req[L];
  unsigned key[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int c = gl + j * G;
    float q = -INFINITY;
    if (c < n) {
      for (int i = 0; i < n; ++i) {
        int k = sv[i] + c;
        if (k >= n) k -= n;
        const float r = scaled_residual(lz[k], rg[i], fs[i], tu[i]);
        if (r > q || isnan(r)) q = r;  // NaN propagates, as in amax
        if (isnan(q)) break;
      }
    }
    req[j] = q;
    key[j] = c < n ? min_key(q) : kFull;
  }
  int c_best;
  group_first_min<G, L>(key, gmask, base, c_best);
  const float best = __shfl_sync(gmask, pick<L>(req, c_best / G), c_best % G, G);
  if (gl == 0) {
    ltd[t0 + grp] = req[0];
    ltc[t0 + grp] = best;
  }
}

template <int G, int L>
int launch(const float* laser, const float* ring, const float* fsr,
           const float* tr_unit, const int* s, int n_trials, int n, float* ltd,
           float* ltc, cudaStream_t stream) {
  constexpr int per_block = (kThreads / 32) * (32 / G);
  const int blocks = (n_trials + per_block - 1) / per_block;
  feasibility_kernel<G, L><<<blocks, kThreads, 0, stream>>>(
      laser, ring, fsr, tr_unit, s, n_trials, n, ltd, ltc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int feasibility_launch(const float* laser, const float* ring,
                                  const float* fsr, const float* tr_unit,
                                  const int* s, int n_trials, int n, float* ltd,
                                  float* ltc, cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  if (n <= 8)
    return launch<8, 1>(laser, ring, fsr, tr_unit, s, n_trials, n, ltd, ltc, stream);
  if (n <= 16)
    return launch<16, 1>(laser, ring, fsr, tr_unit, s, n_trials, n, ltd, ltc, stream);
  if (n <= 32)
    return launch<32, 1>(laser, ring, fsr, tr_unit, s, n_trials, n, ltd, ltc, stream);
  return launch<32, 2>(laser, ring, fsr, tr_unit, s, n_trials, n, ltd, ltc, stream);
}
