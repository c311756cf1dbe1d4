// Bottleneck perfect-matching threshold: the ideal LtA minimum mean TR.
//
// Replaces the Pallas TPU kernel `_bottleneck_kernel` (bottleneck_pallas) in
// src/repro/kernels/bitmask_match.py, which mirrors the reference's
// `_bottleneck_threshold_sweep` (src/repro/core/matching.py).  For each trial
// the result is the least t such that {w <= t} holds a perfect matching.
//
// Rings are inserted one at a time.  For ring i: dist = w[i], parent = i;
// select-relax steps each settle the first line attaining the least
// unsettled dist and, if that line is matched, relax through its ring r with
// cand = max(dist, w[r][k]) and a strict `cand < dist` (free lines are never
// expanded); the cheapest free line (lowest index on ties; line 0 if every
// free line is at +inf) gives this ring's augmentation cost,
// thr = max(thr, cost), and the path is walked back to i with `prev` clamped
// to 0.  Only comparisons and maxima of input values are taken, so the
// result is one of the trial's N^2 weights and equals the reference bit for
// bit.
//
// What bounds it on an H100: the serial search, not memory.  A trial reads
// N^2 floats (4 KB at N = 32) and writes one; the reference's search is N
// rings x N steps x an N-wide first-min, N^3 dependent compares a trial.
// Here a group of G lanes takes one trial, G = 8, 16, 32 for N <= 8, 16, 32
// (a warp takes 32 / G trials) and one warp with two lines a lane for
// N <= 64.  Lane k holds dist, parent and the matched ring of line k, and
// the matched line of ring k, all in registers.  The warp stages its trials'
// weights once in shared memory (16-byte loads where every trial starts on a
// 16-byte boundary), interleaved by trial so that lane k of every group
// reading w[r][k] of its own row r hits distinct banks.
//
// - Select is a group reduction over order-preserving keys: the float's bits
//   mapped so that unsigned order is float order, -0 and +0 one key, settled
//   lines at the key of +inf.  The least key comes from shuffles (a redux at
//   G = 32), the first line holding it from a ballot and __ffs, so the
//   serial scan's "first index attaining the least" is kept, also when every
//   key is +inf.  The relax is one compare per lane.
// - Early stop, exact.  A ring's steps stop once the least unsettled dist is
//   +inf (no later step changes anything) or strictly greater than the dist
//   f of a settled free line.  Settled values never change and every later
//   cand is >= the dist selected, so no free line can fall to f or below
//   later; lines tied at f are settled before the stop, so the first free
//   line attaining the least dist is the serial search's; and the chosen path
//   runs through settled lines only (a line's parent ring r was relaxed from
//   r's matched line, settled then), whose parents are final.
// - The walk-back moves the path by shuffles, at most N dependent steps.
//
// Domain: weights are finite or +-inf (scaled residuals are >= 0); the keys
// order +-inf correctly.  NaN is outside it: the serial scan does not order
// it either.  A warp past the ragged trial edge returns whole; a group past
// it returns after the warp's staging.  Only warp-level barriers are used,
// and every shuffle and ballot names its group's lanes alone.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyInf = 0xff800000u;  // order_key(+inf)

__host__ __device__ constexpr int warps_per_block(int lines_per_lane) {
  return lines_per_lane == 1 ? 4 : 2;
}

// a < b <=> order_key(a) < order_key(b), for floats that are not NaN.
__device__ __forceinline__ unsigned order_key(float x) {
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

// The value that the lane holding index x (line or ring) keeps in a.
template <int G, int L, typename T>
__device__ __forceinline__ T fetch(const T (&a)[L], int x, unsigned gmask) {
  return __shfl_sync(gmask, pick<L>(a, x / G), x % G, G);
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
__global__ void __launch_bounds__(32 * warps_per_block(L))
bottleneck_kernel(const float* __restrict__ w_in, int n_trials, int n, bool vec,
                  float* __restrict__ thr_out) {
  constexpr int kTrialsPerWarp = 32 / G;
  constexpr int kWarps = warps_per_block(L);
  constexpr int kRegion = kTrialsPerWarp * (G * L) * (G * L);  // floats a warp
  __shared__ __align__(16) float smem[kWarps * kRegion];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % G;
  const int grp = lane / G;
  const int base = lane - gl;
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kTrialsPerWarp;
  if (t0 >= n_trials) return;  // the whole warp
  const int nn = n * n;
  const long long left = n_trials - t0;  // trials from the warp's first on
  const int n_here = left < kTrialsPerWarp ? static_cast<int>(left) : kTrialsPerWarp;

  // Stage: element e of the warp's trial g goes to sw[e * kTrialsPerWarp + g].
  float* sw = smem + warp * kRegion;
  const float* src = w_in + t0 * nn;
  if (vec) {
    const int quads = nn / 4;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = lane; q < n_here * quads; q += 32) {
      const float4 v = src4[q];
      const int g = q / quads;
      float* d = sw + (4 * (q - g * quads)) * kTrialsPerWarp + g;
      d[0] = v.x;
      d[kTrialsPerWarp] = v.y;
      d[2 * kTrialsPerWarp] = v.z;
      d[3 * kTrialsPerWarp] = v.w;
    }
  } else {
    for (int f = lane; f < n_here * nn; f += 32) {
      const int g = f / nn;
      sw[(f - g * nn) * kTrialsPerWarp + g] = src[f];
    }
  }
  __syncwarp();
  if (grp >= n_here) return;  // a group past the ragged edge

  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << base;
  const float* wt = sw + grp;  // w[r][k] = wt[(r * n + k) * kTrialsPerWarp]

  int match_rg[L];  // line gl + j * G -> ring, -1 if free
  int match_wl[L];  // ring gl + j * G -> line, -1 if unmatched
#pragma unroll
  for (int j = 0; j < L; ++j) match_rg[j] = match_wl[j] = -1;

  float thr = -INFINITY;
  for (int i = 0; i < n; ++i) {
    float dist[L];
    int parent[L];
    bool open[L];  // a line of the trial, not yet settled
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int k = gl + j * G;
      open[j] = k < n;
      dist[j] = open[j] ? wt[(i * n + k) * kTrialsPerWarp] : INFINITY;
      parent[j] = i;
    }
    unsigned free_key = kFull;  // least key of a settled free line; none yet
    for (int step = 0; step < n; ++step) {
      unsigned key[L];
#pragma unroll
      for (int j = 0; j < L; ++j) key[j] = open[j] ? order_key(dist[j]) : kKeyInf;
      int kk;
      const unsigned kmin = group_first_min<G, L>(key, gmask, base, kk);
      if (kmin == kKeyInf || kmin > free_key) break;
      const float dk = fetch<G>(dist, kk, gmask);
      const int r = fetch<G>(match_rg, kk, gmask);
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (gl + j * G == kk) open[j] = false;
      if (r < 0) {  // a free line ends its path
        free_key = min(free_key, kmin);
        continue;
      }
      const float* wr = wt + r * n * kTrialsPerWarp;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (!open[j]) continue;
        const float wk = wr[(gl + j * G) * kTrialsPerWarp];
        const float cand = wk > dk ? wk : dk;
        if (cand < dist[j]) {
          dist[j] = cand;
          parent[j] = r;
        }
      }
    }

    // The cheapest free line; matched lines count as +inf.
    float fval[L];
    unsigned fkey[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      fval[j] = gl + j * G < n && match_rg[j] < 0 ? dist[j] : INFINITY;
      fkey[j] = order_key(fval[j]);
    }
    int k;
    group_first_min<G, L>(fkey, gmask, base, k);
    const float best = fetch<G>(fval, k, gmask);
    if (best > thr) thr = best;

    for (int step = 0; step < n; ++step) {
      const int r = fetch<G>(parent, k, gmask);
      const int prev = fetch<G>(match_wl, r, gmask);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (gl + j * G == r) match_wl[j] = k;
        if (gl + j * G == k) match_rg[j] = r;
      }
      if (r == i) break;
      k = prev > 0 ? prev : 0;
    }
  }
  if (gl == 0) thr_out[t0 + grp] = thr;
}

template <int G, int L>
int launch(const float* w, int n_trials, int n, float* thr, cudaStream_t stream) {
  constexpr int kWarps = warps_per_block(L);
  constexpr int per_block = kWarps * (32 / G);
  const int blocks = (n_trials + per_block - 1) / per_block;
  // 16-byte loads need every trial to start on a 16-byte boundary.
  const bool vec = (n * n) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  bottleneck_kernel<G, L><<<blocks, 32 * kWarps, 0, stream>>>(w, n_trials, n, vec, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bottleneck_launch(const float* w, int n_trials, int n, float* thr,
                                 cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  if (n <= 8) return launch<8, 1>(w, n_trials, n, thr, stream);
  if (n <= 16) return launch<16, 1>(w, n_trials, n, thr, stream);
  if (n <= 32) return launch<32, 1>(w, n_trials, n, thr, stream);
  return launch<32, 2>(w, n_trials, n, thr, stream);
}
