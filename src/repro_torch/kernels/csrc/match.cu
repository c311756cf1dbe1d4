// Kuhn maximum bipartite matching on per-ring line bitmasks (ideal LtA).
//
// Replaces the Pallas TPU kernel `_match_kernel` (match_pallas) in
// src/repro/kernels/bitmask_match.py, and covers the reference's multiword
// core path (`max_matching` on (T, N, W) uint32 words, N > 32) as well: one
// 64-bit word per ring holds N <= 64 lines.
//
// The search order, which defines `match_wl` on every trial, perfect or not:
// rings are inserted in index order; for ring i a BFS over alternating paths
// takes, level by level, the lowest free line of the frontier, and otherwise
// grows the frontier through the matched rings whose line is in it, in ring
// order, so the lowest-index ring that reaches a line becomes its parent; it
// stops at the first level with a free line, or with an empty frontier (ring
// i stays unmatched).  The augmenting path is walked back along the parents,
// stopping at ring i or at a ring that was unmatched.
//
// What bounds it on an H100: neither bytes nor arithmetic but the
// instructions each trial's search issues.  A trial reads N words and writes
// N + 1/4 words (3.9 MB at N = 32 and 10,000 trials, about 1.2 us at
// 3.35 TB/s), and on the main path's inputs almost every ring finds a free
// line in its own word, a BFS of one level.  So each trial gets a group of G
// lanes, G = 8, 16, 32 for N <= 8, 16, 32 (a warp takes 32 / G trials), and
// one warp with two rings and lines a lane (x and x + 32) for N <= 64; sets
// of rings or lines are 32-bit words up to N = 32 and 64-bit words above.
// Lane x holds ring x's word, ring x's matched line and the BFS parent of
// line x in registers; `matched`, `frontier`, `visited` and `reached` are
// words uniform over the group.  Lane x loads ring x's word, so a group reads
// its trial's row of N * 8 contiguous bytes; lanes x >= N hold word 0 and
// line -1, so they never enter a frontier or fail the `ok` test.
//
// Why this is the serial order:
// - Level 0 is a shuffle of ring i's word and a test against `matched`: the
//   lowest free line of the start frontier, or nothing.  No parent is
//   written on this path: a path of one edge needs none.
// - A deeper level ballots the set R of matched rings whose line is in the
//   frontier.  The serial loop walks R in ring order and gives each line not
//   yet visited the first ring of R that reaches it: the lowest ring of
//   R & col[k], where col[k] is the set of rings that reach line k.  Lane k
//   holds col[k], so every line of a level takes its parent at once, and a
//   ballot of the lines that found one is the level's `reached`.  col is the
//   transpose of the rings' words, N ballots, built at a trial's first deeper
//   level (most trials of the main path never reach one).
// - `matched` needs no rebuild: an augmentation re-matches every line on its
//   path but one, the free line, so the matched lines grow by that line.
//   Parents need no reset: the walk-back reads only lines this BFS reached,
//   and each of those was written in it.
//
// Warp-level only: every shuffle and ballot names its group's lanes, there
// are no block barriers, and a group past the ragged trial edge returns at
// once.  Words are unsigned (`1 << 31` in int is negative) and never shifted
// by their width; they are cut to their N low bits on load.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxN = 64;
constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;
using u64 = unsigned long long;

// Index of the lowest set bit; x != 0.  (__ffs and __ffsll are 1-based.)
__device__ __forceinline__ int lowest_bit(unsigned x) { return __ffs(x) - 1; }
__device__ __forceinline__ int lowest_bit(u64 x) {
  return __ffsll(static_cast<long long>(x)) - 1;
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

// The value that the lane holding index x (ring or line) keeps in a.
template <int G, int L, typename T>
__device__ __forceinline__ T fetch(const T (&a)[L], int x, unsigned gmask) {
  return __shfl_sync(gmask, pick<L>(a, x / G), x % G, G);
}

// The group's indices x = gl + j * G where pred[j] holds, as a set.
template <int G, int L, typename W>
__device__ __forceinline__ W group_ballot(const bool (&pred)[L], unsigned gmask,
                                          int base) {
  W set = 0;
#pragma unroll
  for (int j = 0; j < L; ++j)
    set |= static_cast<W>((__ballot_sync(gmask, pred[j]) & gmask) >> base) << (j * G);
  return set;
}

template <int G, int L>
__global__ void __launch_bounds__(kBlock)
match_kernel(const long long* __restrict__ adj_in, int n_trials, int n,
             int* __restrict__ match_wl_out, unsigned char* __restrict__ ok_out) {
  using W = std::conditional_t<L == 1, unsigned, u64>;  // a set of rings or lines
  constexpr int kBits = 8 * sizeof(W);
  constexpr int kTrialsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const int base = lane - gl;
  const long long t =
      (static_cast<long long>(blockIdx.x) * (kBlock / 32) + (threadIdx.x >> 5)) *
          kTrialsPerWarp + lane / G;
  if (t >= n_trials) return;  // the whole group
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << base;
  const W lines = ~W(0) >> (kBits - n);

  W adj[L];         // ring x's lines
  W col[L];         // line x's rings, once built
  int match_wl[L];  // ring x -> line, -1 if unmatched
  int parent[L];    // line x -> ring that reached it in this ring's BFS
  const long long* row = adj_in + t * n;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int x = gl + j * G;
    adj[j] = x < n ? static_cast<W>(row[x]) & lines : W(0);
    col[j] = 0;
    match_wl[j] = -1;
    parent[j] = -1;
  }

  bool have_col = false;
  W matched = 0;
  for (int i = 0; i < n; ++i) {
    const W start = fetch<G>(adj, i, gmask);
    W hit = start & ~matched;
    if (hit != 0) {  // level 0: a path of one edge
      const int k = lowest_bit(hit);
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (gl + j * G == i) match_wl[j] = k;
      matched |= W(1) << k;
      continue;
    }
    if (start == 0) continue;

    if (!have_col) {  // transpose: col[k] = the rings whose word holds line k
      for (int k = 0; k < n; ++k) {
        bool has[L];
#pragma unroll
        for (int j = 0; j < L; ++j) has[j] = (adj[j] >> k) & 1;
        const W c = group_ballot<G, L, W>(has, gmask, base);
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (gl + j * G == k) col[j] = c;
      }
      have_col = true;
    }
#pragma unroll
    for (int j = 0; j < L; ++j)
      if ((start >> (gl + j * G)) & 1) parent[j] = i;
    W frontier = start;
    W visited = start;
    int free_wl = -1;
    for (;;) {
      bool in_front[L];
#pragma unroll
      for (int j = 0; j < L; ++j)
        in_front[j] = match_wl[j] >= 0 && ((frontier >> match_wl[j]) & 1);
      const W rings = group_ballot<G, L, W>(in_front, gmask, base);
      bool fresh[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const W by = col[j] & rings;
        fresh[j] = by != 0 && !((visited >> (gl + j * G)) & 1);
        if (fresh[j]) parent[j] = lowest_bit(by);
      }
      const W reached = group_ballot<G, L, W>(fresh, gmask, base);
      if (reached == 0) break;  // ring i stays unmatched
      visited |= reached;
      hit = reached & ~matched;
      if (hit != 0) {
        free_wl = lowest_bit(hit);
        break;
      }
      frontier = reached;
    }
    if (free_wl < 0) continue;

    // Walk back: each ring on the path takes the line it reached.
    int k = free_wl;
    for (int step = 0; step < n; ++step) {
      const int r = fetch<G>(parent, k, gmask);
      const int prev = fetch<G>(match_wl, r, gmask);
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (gl + j * G == r) match_wl[j] = k;
      if (r == i || prev < 0) break;
      k = prev;
    }
    matched |= W(1) << free_wl;
  }

  bool done[L];
  int* out = match_wl_out + t * n;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int x = gl + j * G;
    if (x < n) out[x] = match_wl[j];
    done[j] = x >= n || match_wl[j] >= 0;
  }
  const W all = group_ballot<G, L, W>(done, gmask, base);
  if (gl == 0) ok_out[t] = all == ~W(0) >> (kBits - L * G);
}

template <int G, int L>
int launch(const long long* adj, int n_trials, int n, int* match_wl,
           unsigned char* ok, cudaStream_t stream) {
  constexpr int per_block = (kBlock / 32) * (32 / G);
  const int blocks = (n_trials + per_block - 1) / per_block;
  match_kernel<G, L><<<blocks, kBlock, 0, stream>>>(adj, n_trials, n, match_wl, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int match_launch(const long long* adj, int n_trials, int n,
                            int* match_wl, unsigned char* ok,
                            cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  if (n <= 8) return launch<8, 1>(adj, n_trials, n, match_wl, ok, stream);
  if (n <= 16) return launch<16, 1>(adj, n_trials, n, match_wl, ok, stream);
  if (n <= 32) return launch<32, 1>(adj, n_trials, n, match_wl, ok, stream);
  return launch<32, 2>(adj, n_trials, n, match_wl, ok, stream);
}
