// Batched masked re-search: the protocol engine's unit primitive.
//
// Replaces the Pallas TPU kernel `_research_kernel` (research_pallas) in
// src/repro/kernels/probe.py.  For each (trial, table row) it returns the
// first entry e >= floor whose line id is valid (>= 0) and not captured:
//
//   wl     (T, C, E) int32   line id of each entry, -1 padding
//   taken  (T, L)    bool    captured-line mask of the trial
//   floor  (T, C)    int32   first admissible entry (negative admits all)
//   first  (T, C)    int32   chosen entry, -1 if none is visible
//   found  (T, C)    bool
//
// A line id >= L counts as not captured, as in the reference (it routes such
// ids to an all-False pad column), so the entry is visible.  A floor >= E
// finds nothing; an all-invalid row finds nothing.
//
// What bounds it on an H100: bytes, and at 10,000 trials the latency of one
// launch.  It writes T*C*5 bytes and must read, of each row, the 32-byte
// sectors from its floor to its first visible entry, plus the trial's L mask
// bytes and the C floors (chip_smoke.py's probe_cost counts them on the run's
// data): about a microsecond at 3.35 TB/s.  The TPU kernel has no gather
// across sublanes, so it builds the captured mask of every entry with an
// L-step one-hot pass and takes a masked iota-min over all E entries.  Here
// a group of G lanes takes one (trial, row), G the power of two in [4, 32]
// that covers the row at 8 entries a lane (G = 4 at E = 24, 16 at E = 96,
// 32 at E = 192), so a warp takes 32 / G rows.  Each lane loads its 8 line
// ids at once (two 16-byte loads where the row is aligned), gathers their
// captured bytes (L <= 64 bytes, in L1) and keeps its first visible entry;
// the group's first lane with one, from a ballot and __ffs, gives the row's.
// The floor, the line ids and the mask bytes are each one round trip, all
// independent across the row, in place of a chain of dependent loads per
// entry.  Rows longer than 8G entries take further passes until every row of
// the warp has its answer.  A warp past the ragged edge returns as a whole;
// a group past it takes part in the warp's ballots and writes nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 8;  // entries a lane examines per pass
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

template <int G, bool kVec>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ wl, const unsigned char* __restrict__ taken,
             const int* __restrict__ floor_in, long long n_rows_total, int n_rows,
             int n_entries, int n_lines, int* __restrict__ first_out,
             unsigned char* __restrict__ found_out) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the row's group
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  if (row0 >= n_rows_total) return;  // the whole warp
  const long long row = row0 + lane / G;
  const bool live = row < n_rows_total;
  const unsigned group_bits =
      G == 32 ? kFull : ((1u << G) - 1u) << (lane - gl);

  const int* r = wl + row * n_entries;
  const unsigned char* mask = taken + (row / n_rows) * n_lines;
  const int start = live ? max(floor_in[row], 0) : kNone;

  int first = -1;
  bool done = !live;
  for (int pass = 0;; ++pass) {
    const int e0 = (pass * G + gl) * kPerLane;
    int ids[kPerLane];
    int mine = kNone;  // this lane's first visible entry
    if (!done && e0 < n_entries && e0 + kPerLane > start) {
      if (kVec) {
        const int4 a = *reinterpret_cast<const int4*>(r + e0);
        ids[0] = a.x; ids[1] = a.y; ids[2] = a.z; ids[3] = a.w;
        if (e0 + 4 < n_entries) {
          const int4 b = *reinterpret_cast<const int4*>(r + e0 + 4);
          ids[4] = b.x; ids[5] = b.y; ids[6] = b.z; ids[7] = b.w;
        } else {
          ids[4] = ids[5] = ids[6] = ids[7] = -1;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kPerLane; ++q)
          ids[q] = e0 + q < n_entries ? r[e0 + q] : -1;
      }
      bool capt[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        capt[q] = ids[q] >= 0 && ids[q] < n_lines && mask[ids[q]] != 0;
#pragma unroll
      for (int q = kPerLane - 1; q >= 0; --q) {
        const int e = e0 + q;
        if (e >= start && ids[q] >= 0 && !capt[q]) mine = e;
      }
    }
    const unsigned hits = __ballot_sync(kFull, mine != kNone) & group_bits;
    const int src = hits != 0u ? __ffs(hits) - 1 : lane;
    const int got = __shfl_sync(kFull, mine, src);
    if (!done && hits != 0u) {
      first = got;
      done = true;
    }
    if ((pass + 1) * G * kPerLane >= n_entries) done = true;
    if (__all_sync(kFull, done)) break;
  }
  if (live && gl == 0) {
    first_out[row] = first;
    found_out[row] = first >= 0 ? 1 : 0;
  }
}

template <int G>
int launch(bool vec, const int* wl, const unsigned char* taken, const int* floor_in,
           long long n, int n_rows, int n_entries, int n_lines, int* first,
           unsigned char* found, cudaStream_t stream) {
  const long long rows_per_block = (kThreads / 32) * (32 / G);
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec)
    probe_kernel<G, true><<<grid, kThreads, 0, stream>>>(
        wl, taken, floor_in, n, n_rows, n_entries, n_lines, first, found);
  else
    probe_kernel<G, false><<<grid, kThreads, 0, stream>>>(
        wl, taken, floor_in, n, n_rows, n_entries, n_lines, first, found);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_launch(const int* wl, const unsigned char* taken,
                            const int* floor_in, int n_trials, int n_rows,
                            int n_entries, int n_lines, int* first,
                            unsigned char* found, cudaStream_t stream) {
  if (n_rows < 1 || n_entries < 1 || n_lines < 1 || n_entries > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_trials) * n_rows;
  if (n == 0) return 0;
  // 16-byte loads need every row to start on a 16-byte boundary.
  const bool vec = n_entries % 4 == 0 && reinterpret_cast<uintptr_t>(wl) % 16 == 0;
  const int lanes = (n_entries + kPerLane - 1) / kPerLane;
  if (lanes <= 4)
    return launch<4>(vec, wl, taken, floor_in, n, n_rows, n_entries, n_lines, first,
                     found, stream);
  if (lanes <= 8)
    return launch<8>(vec, wl, taken, floor_in, n, n_rows, n_entries, n_lines, first,
                     found, stream);
  if (lanes <= 16)
    return launch<16>(vec, wl, taken, floor_in, n, n_rows, n_entries, n_lines, first,
                      found, stream);
  return launch<32>(vec, wl, taken, floor_in, n, n_rows, n_entries, n_lines, first,
                    found, stream);
}
