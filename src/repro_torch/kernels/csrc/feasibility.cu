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
//
// What bounds it on an H100: memory.  A trial reads 4*N floats and writes
// two; at N = 32 and 10,000 trials that is 5.1 MB, about 1.6 us at
// 3.35 TB/s, so launch overhead dominates.  The simple design: one thread per
// trial, reading its rows of the core (T, N) layout directly (no transpose
// pass), shifts on the outside and rings on the inside so each of the N*N
// residuals is computed once and never stored.  The ordering s sits in
// shared memory; the ragged trial edge is masked.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kBlock = 128;

__device__ __forceinline__ float scaled_residual(float laser, float ring, float fsr,
                                                 float tr_unit) {
  float m = fmodf(laser - ring, fsr);
  if (m != 0.0f && ((m < 0.0f) != (fsr < 0.0f))) m += fsr;
  return m / tr_unit;
}

__global__ void feasibility_kernel(const float* __restrict__ laser,
                                   const float* __restrict__ ring,
                                   const float* __restrict__ fsr,
                                   const float* __restrict__ tr_unit,
                                   const int* __restrict__ s, int n_trials, int n,
                                   float* __restrict__ ltd, float* __restrict__ ltc) {
  __shared__ int s_sh[kMaxN];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_sh[i] = s[i];
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_trials) return;
  const size_t row = static_cast<size_t>(t) * n;
  const float* lz = laser + row;
  const float* rg = ring + row;
  const float* fs = fsr + row;
  const float* tu = tr_unit + row;

  float ltd_v = 0.0f;
  float best = INFINITY;
  for (int c = 0; c < n; ++c) {
    float req = -INFINITY;
    for (int i = 0; i < n; ++i) {
      int k = s_sh[i] + c;
      if (k >= n) k -= n;
      const float r = scaled_residual(lz[k], rg[i], fs[i], tu[i]);
      if (r > req || isnan(r)) req = r;  // NaN propagates, as in amax
      if (isnan(req)) break;
    }
    if (c == 0) ltd_v = req;
    if (req < best || isnan(req)) best = req;
    if (isnan(best)) break;
  }
  ltd[t] = ltd_v;
  ltc[t] = best;
}

}  // namespace

extern "C" int feasibility_launch(const float* laser, const float* ring,
                                  const float* fsr, const float* tr_unit,
                                  const int* s, int n_trials, int n, float* ltd,
                                  float* ltc, cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  const int blocks = (n_trials + kBlock - 1) / kBlock;
  feasibility_kernel<<<blocks, kBlock, 0, stream>>>(laser, ring, fsr, tr_unit, s,
                                                    n_trials, n, ltd, ltc);
  return static_cast<int>(cudaGetLastError());
}
