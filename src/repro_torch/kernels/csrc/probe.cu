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
// ids to an all-False pad column), so the entry is visible.
//
// What bounds it on an H100: bytes.  It writes T*C*5 bytes and reads at most
// T*(C*E*4 + L + C*4): a row is read only from its floor to its first visible
// entry, so the bytes it must move depend on the data (chip_smoke.py's
// probe_cost counts the 32-byte sectors a run scans).  The TPU kernel has no
// gather across sublanes, so it builds the captured mask of every entry with
// an L-step one-hot pass and takes a masked iota-min over all E entries.  A
// thread here gathers directly: one thread per (trial, row), walking the
// row's line ids in order, reading the trial's captured byte for each, and
// stopping at the first visible entry.  The row is contiguous in the port's
// (T, C, E) layout, so a thread's reads hit the same cache lines; the mask
// of a trial (L <= 64 bytes) stays in L1.  The ragged trial edge is masked.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__global__ void probe_kernel(const int* __restrict__ wl,
                             const unsigned char* __restrict__ taken,
                             const int* __restrict__ floor_in, int n_trials,
                             int n_rows, int n_entries, int n_lines,
                             int* __restrict__ first_out,
                             unsigned char* __restrict__ found_out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n_trials) * n_rows) return;
  const long long t = idx / n_rows;

  const int* row = wl + idx * n_entries;
  const unsigned char* mask = taken + t * n_lines;
  int first = -1;
  for (int e = max(floor_in[idx], 0); e < n_entries; ++e) {
    const int line = row[e];
    if (line >= 0 && (line >= n_lines || mask[line] == 0)) {
      first = e;
      break;
    }
  }
  first_out[idx] = first;
  found_out[idx] = first >= 0 ? 1 : 0;
}

}  // namespace

extern "C" int probe_launch(const int* wl, const unsigned char* taken,
                            const int* floor_in, int n_trials, int n_rows,
                            int n_entries, int n_lines, int* first,
                            unsigned char* found, cudaStream_t stream) {
  if (n_rows < 1 || n_entries < 1 || n_lines < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_trials) * n_rows;
  if (n == 0) return 0;
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  probe_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0, stream>>>(
      wl, taken, floor_in, n_trials, n_rows, n_entries, n_lines, first, found);
  return static_cast<int>(cudaGetLastError());
}
