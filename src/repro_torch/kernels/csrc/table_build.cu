// Search-table construction: per (trial, ring), the first E peaks of the
// wavelength search in ascending tuning distance.
//
// Replaces the Pallas TPU kernel `_table_kernel` (table_pallas, with its
// helpers `_bitonic_sort` and `_bitonic_merge`) in
// src/repro/kernels/table_build.py.  Candidates are
//   delta = (laser_k - ring_i) - j * fsr_i,   j in [-J, J],
// kept when 0 <= delta <= tr_i (and line k is visible to ring i).  The table
// holds the first E in (delta, k * (2J+1) + j) order: delta (+inf padded),
// wl = k (-1 padded) and n_valid, in the core (T, N, E) layout.  Products and
// differences are rounded one by one (__fmul_rn, __fsub_rn; the build also
// passes --fmad=false), as in the reference, so delta equals the plain
// version bit for bit.
//
// What bounds it on an H100: the write.  At N = 32, E = 96 and 10,000 trials
// the outputs are about 247 MB (74 us at 3.35 TB/s) against 5 MB of input,
// most of them +inf / -1 padding: about 8 of a row's N * (2J+1) = 544
// candidates fall in the window at TR 8.96.  The TPU kernel streams alias
// groups through a bitonic rank-merge in VMEM.  Here a group of G lanes
// takes one (trial, ring) row, G the least power of two in [8, 32] with
// 2G >= N, so a warp takes 32 / G consecutive rows:
//
// - Scan.  Each lane takes one or two lines k and tests only the aliases j
//   that can put delta in the window (alias_range: a superset, from the
//   quotients (laser_k - ring_i) / fsr_i and (laser_k - ring_i - tr_i) /
//   fsr_i; 2 to 4 per line at TR 8.96), with the exact test of the plain
//   version.  A ballot picks the candidates in the window, and their lanes
//   append them to the row's staging list in shared memory at the ballot's
//   prefix count.
// - Selection.  When a staging list is full, and once at the end, it is
//   merged by rank into the row's sorted top-E buffer in shared memory
//   (delta and the key (k << 16) | (j + J), whose order is the flat index's):
//   a staged candidate goes to (staged candidates with a smaller (delta, key))
//   + (kept entries with a smaller one, by binary search); a kept entry moves
//   down by the staged candidates with a smaller one; ranks >= E drop out.
//   The flat index breaks every delta tie, so this is the reference's
//   compound (delta, flat) order (the stable argsort of
//   build_search_tables_dense), whatever order the candidates came in and
//   however many fall in the window.  Once the buffer holds E entries, a
//   candidate that does not beat its last one is not staged.
// - Write.  The group writes its row from the buffer, lanes on consecutive
//   entries, 16-byte stores where E is a multiple of 4; a warp's rows, and a
//   block's, are one contiguous span.
//
// Shared memory per row is (2E + max(E, 32)) * 8 bytes, bounded by E and not
// by J; a block takes as many warps as 48 KB holds, at most 8.  Nothing is
// kept in per-thread local memory.  A warp past the ragged row edge returns
// as a whole; a group past it takes part in the warp's ballots and writes
// nothing.  Only warp-level barriers are used.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxE = 192;
constexpr int kMaxAlias = 32767;  // j + J must fit the key's low 16 bits
constexpr int kMaxWarps = 8;      // warps per block
constexpr int kSmemBudget = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSafeQuotient = 1048576.0f;  // 2^20: see alias_range

__device__ __forceinline__ bool key_less(float da, int ka, float db, int kb) {
  return da < db || (da == db && ka < kb);
}

// The aliases j in [lo, hi] of one (ring, line) pair that can pass the
// window test 0 <= diff - j * fsr <= tr: a superset of those that do, so
// the exact test on them alone finds every candidate.  The quotients
// q = diff / fsr and q' = (diff - tr) / fsr, through a rounded reciprocal,
// are within 3/16 of the exact ones while they are below 2^20.  Then any
// j > floor(q) + 1 puts diff - j * fsr below -(3/4) fsr, and any
// j < ceil(q') - 1 puts it above tr + (3/4) fsr; rounding j * fsr moves it by
// under fsr / 512 (|j| < 2^15), and half an ulp of tr is under fsr / 8 there
// (|tr| < 2^21 fsr), so the rounded difference stays out of the window.
// Where fsr is not finite and positive, or a quotient is not finite and
// below 2^20, the range is every alias.
__device__ __forceinline__ void alias_range(float diff, float fsr, float tr, int max_alias,
                                            int& lo, int& hi) {
  lo = -max_alias;
  hi = max_alias;
  if (!(fsr > 0.0f) || !(fsr < INFINITY)) return;
  const float inv = __frcp_rn(fsr);
  const float q_hi = __fmul_rn(diff, inv);
  const float q_lo = __fmul_rn(__fsub_rn(diff, tr), inv);
  if (!(fabsf(q_hi) < kSafeQuotient) || !(fabsf(q_lo) < kSafeQuotient)) return;
  lo = max(lo, static_cast<int>(ceilf(q_lo)) - 1);
  hi = min(hi, static_cast<int>(floorf(q_hi)) + 1);
}

// Line k of ring i: laser_k - ring_i and its alias range, or no aliases
// where the line is past N or not visible.
__device__ __forceinline__ void line_setup(int k, int n, const float* lz,
                                           const unsigned char* vz, float ring_i,
                                           float fsr_i, float tr_i, int max_alias,
                                           float& diff, int& j_lo, int& n_j) {
  if (k >= n || (vz != nullptr && vz[k] == 0)) return;
  diff = __fsub_rn(lz[k], ring_i);
  int hi;
  alias_range(diff, fsr_i, tr_i, max_alias, j_lo, hi);
  n_j = max(hi - j_lo + 1, 0);
}

// Merges a group's ns staged candidates (sd, sk; any order) into its sorted
// buffer of nb entries (xd, xk), writing the sorted first E of both into
// (yd, yk).  The G lanes of the group share the work.
template <int G>
__device__ __forceinline__ void merge_staged(const float* sd, const int* sk, int ns,
                                             const float* xd, const int* xk, int nb,
                                             float* yd, int* yk, int n_entries, int gl) {
  __syncwarp();
  for (int s = gl; s < ns; s += G) {
    const float d = sd[s];
    const int k = sk[s];
    int rank = 0;
    for (int q = 0; q < ns; ++q) rank += key_less(sd[q], sk[q], d, k) ? 1 : 0;
    int lo = 0, hi = nb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(xd[mid], xk[mid], d, k)) lo = mid + 1; else hi = mid;
    }
    rank += lo;
    if (rank < n_entries) {
      yd[rank] = d;
      yk[rank] = k;
    }
  }
  for (int p = gl; p < nb; p += G) {
    const float d = xd[p];
    const int k = xk[p];
    int pos = p;
    for (int q = 0; q < ns; ++q) pos += key_less(sd[q], sk[q], d, k) ? 1 : 0;
    if (pos < n_entries) {
      yd[pos] = d;
      yk[pos] = k;
    }
  }
  __syncwarp();
}

// Words of shared memory one row takes: two top-E buffers and the staging
// list, each deltas then keys; the list holds at least one ballot's worth.
__host__ __device__ __forceinline__ int row_words(int n_entries) {
  return 4 * n_entries + 2 * (n_entries > 32 ? n_entries : 32);
}

template <int G>
__global__ void table_build_kernel(const float* __restrict__ laser,
                                   const float* __restrict__ ring,
                                   const float* __restrict__ fsr,
                                   const float* __restrict__ tr,
                                   const unsigned char* __restrict__ vis,
                                   long long vis_trial_stride, long long vis_ring_stride,
                                   long long n_rows, int n, int max_alias, int n_entries,
                                   bool vec, float* __restrict__ delta,
                                   int* __restrict__ wl, int* __restrict__ n_valid) {
  constexpr int kRowsPerWarp = 32 / G;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the row's group
  const int warp_in_block = threadIdx.x >> 5;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp_in_block) *
      kRowsPerWarp;
  if (row0 >= n_rows) return;  // the whole warp
  const long long row = row0 + lane / G;
  const bool live = row < n_rows;
  const unsigned group_bits = G == 32 ? kFull : ((1u << G) - 1u) << (lane - gl);
  const unsigned lanes_below = (1u << lane) - 1u;

  const int words = row_words(n_entries);
  const int cap = words / 2 - 2 * n_entries;
  float* base = smem + static_cast<long long>(warp_in_block * kRowsPerWarp + lane / G) * words;
  float* xd = base;
  int* xk = reinterpret_cast<int*>(base + n_entries);
  float* yd = base + 2 * n_entries;
  int* yk = reinterpret_cast<int*>(base + 3 * n_entries);
  float* sd = base + 4 * n_entries;
  int* sk = reinterpret_cast<int*>(base + 4 * n_entries + cap);

  // Lines k = gl and k = gl + G of this lane (2G >= N): laser_k - ring_i,
  // and the aliases that can fall in the window, j_lo .. j_lo + n_j - 1.
  float fsr_i = 0.0f, tr_i = 0.0f, diff0 = 0.0f, diff1 = 0.0f;
  int j_lo0 = 0, j_lo1 = 0, n_j0 = 0, n_j1 = 0;
  if (live) {
    const long long t = row / n;
    const long long i = row - t * n;
    const float ring_i = ring[row];
    fsr_i = fsr[row];
    tr_i = tr[row];
    const float* lz = laser + t * n;
    const unsigned char* vz =
        vis == nullptr ? nullptr : vis + t * vis_trial_stride + i * vis_ring_stride;
    line_setup(gl, n, lz, vz, ring_i, fsr_i, tr_i, max_alias, diff0, j_lo0, n_j0);
    line_setup(gl + G, n, lz, vz, ring_i, fsr_i, tr_i, max_alias, diff1, j_lo1, n_j1);
  }
  const int n_tests = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(n_j0 + n_j1)));

  int nb = 0, ns = 0;
  float last_d = 0.0f;  // the buffer's E-th entry, once it is full
  int last_k = 0;
  for (int it = 0; it < n_tests; ++it) {
    // Test it of this lane: alias j_lo0 + it of line gl, then those of gl + G.
    const bool second = it >= n_j0;
    const int jj = second ? it - n_j0 : it;
    bool in = false;
    float d = 0.0f;
    int key = 0;
    if (jj < (second ? n_j1 : n_j0)) {
      const int j = (second ? j_lo1 : j_lo0) + jj;
      d = __fsub_rn(second ? diff1 : diff0, __fmul_rn(static_cast<float>(j), fsr_i));
      key = ((second ? gl + G : gl) << 16) | (j + max_alias);
      in = d >= 0.0f && d <= tr_i && (nb < n_entries || key_less(d, key, last_d, last_k));
    }
    const unsigned ballot = __ballot_sync(kFull, in);
    if (ballot == 0u) continue;
    const unsigned mine = ballot & group_bits;
    const int count = __popc(mine);
    if (__any_sync(kFull, ns + count > cap)) {
      merge_staged<G>(sd, sk, ns, xd, xk, nb, yd, yk, n_entries, gl);
      float* td = xd; xd = yd; yd = td;
      int* tk = xk; xk = yk; yk = tk;
      nb = min(nb + ns, n_entries);
      ns = 0;
      if (nb == n_entries) {
        last_d = xd[n_entries - 1];
        last_k = xk[n_entries - 1];
      }
    }
    if (in) {
      const int pos = ns + __popc(mine & lanes_below);
      sd[pos] = d;
      sk[pos] = key;
    }
    ns += count;
  }
  if (__any_sync(kFull, ns > 0)) {
    merge_staged<G>(sd, sk, ns, xd, xk, nb, yd, yk, n_entries, gl);
    xd = yd;
    xk = yk;
    nb = min(nb + ns, n_entries);
  }
  if (!live) return;

  float* out_d = delta + row * n_entries;
  int* out_w = wl + row * n_entries;
  if (vec) {
    float4* od = reinterpret_cast<float4*>(out_d);
    int4* ow = reinterpret_cast<int4*>(out_w);
    for (int q = gl; q < n_entries / 4; q += G) {
      const int e = 4 * q;
      float4 v;
      int4 w;
      v.x = e < nb ? xd[e] : INFINITY;
      v.y = e + 1 < nb ? xd[e + 1] : INFINITY;
      v.z = e + 2 < nb ? xd[e + 2] : INFINITY;
      v.w = e + 3 < nb ? xd[e + 3] : INFINITY;
      w.x = e < nb ? xk[e] >> 16 : -1;
      w.y = e + 1 < nb ? xk[e + 1] >> 16 : -1;
      w.z = e + 2 < nb ? xk[e + 2] >> 16 : -1;
      w.w = e + 3 < nb ? xk[e + 3] >> 16 : -1;
      od[q] = v;
      ow[q] = w;
    }
  } else {
    for (int e = gl; e < n_entries; e += G) {
      out_d[e] = e < nb ? xd[e] : INFINITY;
      out_w[e] = e < nb ? xk[e] >> 16 : -1;
    }
  }
  if (gl == 0) n_valid[row] = nb;
}

template <int G>
int launch(const float* laser, const float* ring, const float* fsr, const float* tr,
           const unsigned char* vis, long long vis_trial_stride, long long vis_ring_stride,
           long long rows, int n, int max_alias, int n_entries, bool vec, float* delta,
           int* wl, int* n_valid, cudaStream_t stream) {
  // As many warps per block as 48 KB of shared memory holds, at most 8: 8 at
  // E = 3N for every N; 2 at the widest, E = 192 with 4 rows a warp.
  const int warp_bytes = (32 / G) * row_words(n_entries) * static_cast<int>(sizeof(float));
  const int fit = kSmemBudget / warp_bytes;
  const int warps = fit < kMaxWarps ? fit : kMaxWarps;
  const long long rows_per_block = static_cast<long long>(warps) * (32 / G);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (warps < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  table_build_kernel<G><<<static_cast<unsigned>(blocks), warps * 32,
                          static_cast<size_t>(warps) * warp_bytes, stream>>>(
      laser, ring, fsr, tr, vis, vis_trial_stride, vis_ring_stride, rows, n, max_alias,
      n_entries, vec, delta, wl, n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int table_build_launch(const float* laser, const float* ring,
                                  const float* fsr, const float* tr,
                                  const unsigned char* vis, long long vis_trial_stride,
                                  long long vis_ring_stride, int n_trials, int n,
                                  int max_alias, int n_entries, float* delta, int* wl,
                                  int* n_valid, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || n_entries < 1 || n_entries > kMaxE || max_alias < 0 ||
      max_alias > kMaxAlias)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  const long long rows = static_cast<long long>(n_trials) * n;
  // 16-byte stores need every row to start on a 16-byte boundary.
  const bool vec = n_entries % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(delta) | reinterpret_cast<uintptr_t>(wl)) %
                           16 == 0;
  // G lanes a row, the least power of two in [8, 32] with 2G >= N.
  if (n <= 16)
    return launch<8>(laser, ring, fsr, tr, vis, vis_trial_stride, vis_ring_stride, rows,
                     n, max_alias, n_entries, vec, delta, wl, n_valid, stream);
  if (n <= 32)
    return launch<16>(laser, ring, fsr, tr, vis, vis_trial_stride, vis_ring_stride, rows,
                      n, max_alias, n_entries, vec, delta, wl, n_valid, stream);
  return launch<32>(laser, ring, fsr, tr, vis, vis_trial_stride, vis_ring_stride, rows,
                    n, max_alias, n_entries, vec, delta, wl, n_valid, stream);
}
