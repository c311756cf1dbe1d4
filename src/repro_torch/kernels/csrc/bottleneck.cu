// Bottleneck perfect-matching threshold: the ideal LtA minimum mean TR.
//
// Replaces the Pallas TPU kernel `_bottleneck_kernel` (bottleneck_pallas) in
// src/repro/kernels/bitmask_match.py, which mirrors the reference's
// `_bottleneck_threshold_sweep` (src/repro/core/matching.py).  For each trial
// the result is the least t such that {w <= t} holds a perfect matching.
//
// Rings are inserted one at a time.  For ring i: dist = w[i], parent = i;
// N select-relax steps each settle the first line attaining the least
// unsettled dist and, if that line is matched, relax through its ring r with
// cand = max(dist, w[r][k]) and a strict `cand < dist` (free lines are never
// expanded); the cheapest free line (lowest index on ties) gives this ring's
// augmentation cost, thr = max(thr, cost), and the path is walked back to i.
// Only comparisons and maxima of input values are taken, so the result is one
// of the trial's N^2 weights and equals the reference bit for bit.
//
// What bounds it on an H100: the serial search, not memory.  A trial reads
// N^2 floats once from device memory (4 KB at N = 32) and re-reads one ring
// row per relax from L1/L2; it writes one float.  The selection loop alone is
// N^3 compares per trial.  The simple design: one thread per trial, the
// weights left in global memory (cached), dist/parent/matchings in
// per-thread arrays (local memory), the settled set one 64-bit mask; the
// ragged trial edge is masked.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kBlock = 128;
using u64 = unsigned long long;

__global__ void bottleneck_kernel(const float* __restrict__ w_in, int n_trials,
                                  int n, float* __restrict__ thr_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_trials) return;
  const float* w = w_in + static_cast<size_t>(t) * n * n;  // (ring, line)

  float dist[kMaxN];
  int parent[kMaxN];
  int match_wl[kMaxN];  // ring -> line
  int match_rg[kMaxN];  // line -> ring
  for (int k = 0; k < n; ++k) {
    match_wl[k] = -1;
    match_rg[k] = -1;
  }

  float thr = -INFINITY;
  for (int i = 0; i < n; ++i) {
    const float* wi = w + static_cast<size_t>(i) * n;
    for (int k = 0; k < n; ++k) {
      dist[k] = wi[k];
      parent[k] = i;
    }
    u64 settled = 0;
    for (int step = 0; step < n; ++step) {
      // First index attaining the least dist, settled lines counting as +inf.
      int kk = 0;
      float dk = (settled & 1ULL) ? INFINITY : dist[0];
      for (int k = 1; k < n; ++k) {
        const float d = ((settled >> k) & 1ULL) ? INFINITY : dist[k];
        if (d < dk) {
          dk = d;
          kk = k;
        }
      }
      settled |= 1ULL << kk;
      const int r = match_rg[kk];
      if (r < 0) continue;  // a free line ends its path
      const float* wr = w + static_cast<size_t>(r) * n;
      for (int k = 0; k < n; ++k) {
        if ((settled >> k) & 1ULL) continue;
        const float wk = wr[k];
        const float cand = wk > dk ? wk : dk;
        if (cand < dist[k]) {
          dist[k] = cand;
          parent[k] = r;
        }
      }
    }

    int k = 0;
    float best = match_rg[0] < 0 ? dist[0] : INFINITY;
    for (int j = 1; j < n; ++j) {
      const float d = match_rg[j] < 0 ? dist[j] : INFINITY;
      if (d < best) {
        best = d;
        k = j;
      }
    }
    if (best > thr) thr = best;

    for (int step = 0; step < n; ++step) {
      const int r = parent[k];
      const int prev = match_wl[r];
      match_wl[r] = k;
      match_rg[k] = r;
      if (r == i) break;
      k = prev > 0 ? prev : 0;
    }
  }
  thr_out[t] = thr;
}

}  // namespace

extern "C" int bottleneck_launch(const float* w, int n_trials, int n, float* thr,
                                 cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  const int blocks = (n_trials + kBlock - 1) / kBlock;
  bottleneck_kernel<<<blocks, kBlock, 0, stream>>>(w, n_trials, n, thr);
  return static_cast<int>(cudaGetLastError());
}
