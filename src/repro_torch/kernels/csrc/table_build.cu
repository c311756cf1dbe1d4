// Search-table construction: per (trial, ring), the first E peaks of the
// wavelength search in ascending tuning distance.
//
// Replaces the Pallas TPU kernel `_table_kernel` (table_pallas, with its
// helpers `_bitonic_sort` and `_bitonic_merge`) in
// src/repro/kernels/table_build.py.  Candidates are
//   delta = (laser_k - ring_i) - j * fsr_i,   j in [-J, J],
// kept when 0 <= delta <= tr_i (and line k is visible to ring i).  The table
// holds the first E in (delta, k * (2J+1) + j) order: delta (+inf padded),
// wl = k (-1 padded) and n_valid, in the core (T, N, E) layout.
//
// Tie order: candidates are walked in flat order (line k ascending, then
// alias j ascending) and inserted into a sorted top-E buffer with a strict
// `<`, so an earlier flat index wins every delta tie.  That is the stable
// argsort of the dense reference builder and the compound key of the TPU
// kernel.  Built with --fmad=false: `j * fsr` is rounded before the
// subtraction, as in the reference, so delta equals the plain version bit
// for bit.
//
// What bounds it on an H100: the write.  At N = 32, E = 96 and 10,000
// trials the outputs are about 247 MB (74 us at 3.35 TB/s) against 5 MB of
// input.  The simple design: one thread per (trial, ring), its top-E buffer
// in local memory (interleaved across the warp by the hardware), N*(2J+1)
// candidates generated in registers and never stored, the ragged edge masked
// in the kernel.  Each thread writes its own contiguous row of E entries, so
// a warp's stores are strided by E; staging rows through shared memory for
// coalesced stores is left for a later change.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxE = 192;
constexpr int kBlock = 128;

__global__ void table_build_kernel(const float* __restrict__ laser,
                                   const float* __restrict__ ring,
                                   const float* __restrict__ fsr,
                                   const float* __restrict__ tr,
                                   const unsigned char* __restrict__ vis,
                                   long long vis_trial_stride, long long vis_ring_stride,
                                   int n_trials, int n, int max_alias, int n_entries,
                                   float* __restrict__ delta, int* __restrict__ wl,
                                   int* __restrict__ n_valid) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<long long>(n_trials) * n) return;
  const long long t = row / n;
  const long long i = row - t * n;
  const float ring_i = ring[row];
  const float fsr_i = fsr[row];
  const float tr_i = tr[row];
  const float* lz = laser + t * n;
  const unsigned char* vz =
      vis == nullptr ? nullptr : vis + t * vis_trial_stride + i * vis_ring_stride;

  float buf_d[kMaxE];
  int buf_w[kMaxE];
  int count = 0;
  for (int k = 0; k < n; ++k) {
    if (vz != nullptr && vz[k] == 0) continue;
    const float diff = lz[k] - ring_i;
    for (int j = -max_alias; j <= max_alias; ++j) {
      const float d = diff - static_cast<float>(j) * fsr_i;
      if (!(d >= 0.0f && d <= tr_i)) continue;
      if (count == n_entries && !(d < buf_d[n_entries - 1])) continue;
      int p = count < n_entries ? count : n_entries - 1;
      while (p > 0 && d < buf_d[p - 1]) {
        buf_d[p] = buf_d[p - 1];
        buf_w[p] = buf_w[p - 1];
        --p;
      }
      buf_d[p] = d;
      buf_w[p] = k;
      if (count < n_entries) ++count;
    }
  }

  float* out_d = delta + row * n_entries;
  int* out_w = wl + row * n_entries;
  for (int e = 0; e < n_entries; ++e) {
    const bool ok = e < count;
    out_d[e] = ok ? buf_d[e] : INFINITY;
    out_w[e] = ok ? buf_w[e] : -1;
  }
  n_valid[row] = count;
}

}  // namespace

extern "C" int table_build_launch(const float* laser, const float* ring,
                                  const float* fsr, const float* tr,
                                  const unsigned char* vis, long long vis_trial_stride,
                                  long long vis_ring_stride, int n_trials, int n,
                                  int max_alias, int n_entries, float* delta, int* wl,
                                  int* n_valid, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || n_entries < 1 || n_entries > kMaxE || max_alias < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_trials == 0) return 0;
  const long long rows = static_cast<long long>(n_trials) * n;
  const int blocks = static_cast<int>((rows + kBlock - 1) / kBlock);
  table_build_kernel<<<blocks, kBlock, 0, stream>>>(
      laser, ring, fsr, tr, vis, vis_trial_stride, vis_ring_stride, n_trials, n,
      max_alias, n_entries, delta, wl, n_valid);
  return static_cast<int>(cudaGetLastError());
}
