// Kuhn maximum bipartite matching on per-ring line bitmasks (ideal LtA).
//
// Replaces the Pallas TPU kernel `_match_kernel` (match_pallas) in
// src/repro/kernels/bitmask_match.py, and covers the reference's multiword
// core path (`max_matching` on (T, N, W) uint32 words, N > 32) as well: one
// 64-bit word per ring holds N <= 64 lines.
//
// For each ring i in order: the matched-line mask is formed once; a BFS over
// alternating paths takes, level by level, the lowest free line of the
// frontier, and otherwise expands the frontier through the matched rings in
// ring order, so the lowest-index ring that reaches a line becomes its parent;
// the BFS stops at the first level with a free line.  The augmenting path is
// then walked back (at most N steps, stopping at ring i or at a ring that was
// unmatched).  This is the reference's search order exactly, so `match_wl`
// equals the reference on every trial, perfect or not.
//
// What bounds it on an H100: neither bytes nor arithmetic but the serial,
// data-dependent search of each trial (dependent bit scans and row selects).
// A trial reads N words and writes N + 1/4 words; at N = 32 and 10,000
// trials that is 3.9 MB, about 1.2 us at 3.35 TB/s.  The simple design: one
// thread per trial, all its state (adjacency, both matchings, parents) in
// per-thread arrays (local memory, cached in L1), rows read directly from the
// port's (T, N) layout (each thread reads a contiguous row; no transpose
// pass), the ragged trial edge masked.  Masks are unsigned 64-bit throughout:
// `1 << 31` in int is negative and a shift by 64 is undefined.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kBlock = 128;
using u64 = unsigned long long;

// Index of the lowest set bit; x != 0.  (__ffsll is 1-based.)
__device__ __forceinline__ int lowest_bit(u64 x) {
  return __ffsll(static_cast<long long>(x)) - 1;
}

__global__ void match_kernel(const long long* __restrict__ adj_in, int n_trials,
                             int n, int* __restrict__ match_wl_out,
                             unsigned char* __restrict__ ok_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_trials) return;

  u64 adj[kMaxN];
  int match_wl[kMaxN];  // ring -> line, -1 if free
  int match_rg[kMaxN];  // line -> ring, -1 if free
  int parent[kMaxN];    // line -> ring that reached it in the BFS
  const long long* row = adj_in + static_cast<size_t>(t) * n;
  for (int r = 0; r < n; ++r) {
    adj[r] = static_cast<u64>(row[r]);
    match_wl[r] = -1;
    match_rg[r] = -1;
  }

  for (int i = 0; i < n; ++i) {
    u64 matched = 0;
    for (int k = 0; k < n; ++k)
      if (match_rg[k] >= 0) matched |= 1ULL << k;
    const u64 start = adj[i];
    for (int k = 0; k < n; ++k) parent[k] = ((start >> k) & 1ULL) ? i : -1;

    u64 frontier = start;
    u64 visited = start;
    int free_wl = -1;
    for (int level = 0; level < n && frontier != 0; ++level) {
      const u64 free_hit = frontier & ~matched;
      if (free_hit != 0) {
        free_wl = lowest_bit(free_hit);
        break;
      }
      u64 reached = 0;
      for (int r = 0; r < n; ++r) {
        const int w = match_wl[r];
        if (w < 0 || ((frontier >> w) & 1ULL) == 0) continue;
        u64 fresh = adj[r] & ~visited & ~reached;
        reached |= fresh;
        while (fresh != 0) {
          parent[lowest_bit(fresh)] = r;
          fresh &= fresh - 1;
        }
      }
      frontier = reached;
      visited |= reached;
    }

    if (free_wl >= 0) {
      int k = free_wl;
      for (int step = 0; step < n; ++step) {
        const int r = parent[k];
        const int prev = match_wl[r];
        match_wl[r] = k;
        match_rg[k] = r;
        if (r == i || prev < 0) break;
        k = prev;
      }
    }
  }

  bool perfect = true;
  int* out = match_wl_out + static_cast<size_t>(t) * n;
  for (int r = 0; r < n; ++r) {
    out[r] = match_wl[r];
    perfect = perfect && match_wl[r] >= 0;
  }
  ok_out[t] = perfect ? 1 : 0;
}

}  // namespace

extern "C" int match_launch(const long long* adj, int n_trials, int n,
                            int* match_wl, unsigned char* ok,
                            cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  const int blocks = (n_trials + kBlock - 1) / kBlock;
  match_kernel<<<blocks, kBlock, 0, stream>>>(adj, n_trials, n, match_wl, ok);
  return static_cast<int>(cudaGetLastError());
}
