// Work-queue construction by stream compaction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/queue_builder.py:
// _queue_builder_kernel (launched by build_queue_kernel): the row-major
// stream compaction of a (R, C) tile bitmap into the coordinates
// (t / C, t % C) of its set bits, in the order of
// repro/core/workredist.py:static_queue_order, plus the true set-bit count
// n_live (which may exceed the capacity).
//
// Bound on the H100: launch latency.  The bitmaps on the training path hold
// at most a few thousand tiles, a few kilobytes.  The TPU walked the bitmap
// as a sequential grid with a running count in SMEM; here ONE block of 1024
// threads loops over the flattened bitmap in chunks of 1024.  Each chunk is
// an exclusive scan done with a warp ballot (lane offsets by popcount) and a
// shuffle scan over the 32 warp totals; the running count is carried in
// registers from chunk to chunk.  Live elements write their coordinates to
// their slot when it is below the capacity.  The caller zero-fills ii/jj, so
// dead slots hold (0, 0), valid coordinates for the consumer.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
queue_builder_kernel(const int* __restrict__ bitmap, int T, int C, int cap,
                     int* __restrict__ ii, int* __restrict__ jj,
                     int* __restrict__ n_live) {
  __shared__ int warp_excl[32];
  __shared__ int chunk_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int carry = 0;  // the same running count in every thread
  for (int base = 0; base < T; base += kThreads) {
    const int t = base + tid;
    const bool live = t < T && bitmap[t] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    const int lane_excl = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_excl[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int v = warp_excl[lane];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      warp_excl[lane] = incl - v;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (live) {
      const int slot = carry + warp_excl[warp] + lane_excl;
      if (slot < cap) {
        const int r = t / C;
        ii[slot] = r;
        jj[slot] = t - r * C;
      }
    }
    carry += chunk_total;
    __syncthreads();  // warp_excl and chunk_total are rewritten next chunk
  }
  if (tid == 0) *n_live = carry;
}

}  // namespace

// bitmap: (R, C) int32 row-major, T = R * C.  ii, jj: (cap,) int32,
// zero-filled by the caller.  n_live: (1,) int32.  Returns the cudaError_t
// of the launch.
extern "C" int queue_builder_launch(const int* bitmap, int T, int C, int cap,
                                    int* ii, int* jj, int* n_live,
                                    void* stream) {
  queue_builder_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      bitmap, T, C, cap, ii, jj, n_live);
  return (int)cudaGetLastError();
}
