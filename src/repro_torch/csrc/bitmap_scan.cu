// Block any-nonzero bitmap of signed data for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitmap_scan.py:_bitmap_scan_kernel
// (launched by bitmap_scan_kernel): for every (gr, gc) cell of the (M, N)
// signed tensor x, bit = any(|x| > 0).  It runs where no ReLU produced the
// bitmap for free: the opt-in scan of raw signed inputs (the image before the
// first conv, the pooled features before the head).
//
// Bound on the H100: memory.  Each element is read once and each cell's bit
// written once; there is no arithmetic to speak of.  At the first conv's
// input (401,408 x 3 at gran (1, 1)) that is 4.8 MB in and 4.8 MB out, about
// 3 us at 3.35 TB/s, so launch latency dominates.  Design:
//   * a cell of at most kThreadCell elements gets one thread, which reads its
//     few elements itself; at gran (1, 1) neighbouring threads then read
//     neighbouring addresses and write neighbouring bits (coalesced);
//   * a larger cell gets one warp: the lanes stride over the cell's elements
//     and __any_sync reduces the bit in registers, as relu_encode.cu does.
// The ragged edge (M % gr, N % gc) is masked here, so the caller makes no
// padded copy.  x may have any row stride (its columns are contiguous).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThreadCell = 32;

// |v| > 0 is false for NaN: a NaN alone does not make a cell live.
__device__ __forceinline__ bool nonzero(float v) { return fabsf(v) > 0.f; }

__global__ void __launch_bounds__(kThreads)
scan_thread_per_cell(const float* __restrict__ x, long long ld,
                     int* __restrict__ bits, int M, int N, int gr, int gc,
                     int Mc, int Nc) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (cell >= (long long)Mc * Nc) return;
  const int ci = (int)(cell / Nc);
  const int cj = (int)(cell - (long long)ci * Nc);
  const int r0 = ci * gr, c0 = cj * gc;
  const int rows = min(gr, M - r0), cols = min(gc, N - c0);
  bool live = false;
  for (int r = 0; r < rows; ++r) {
    const float* row = x + (long long)(r0 + r) * ld + c0;
    for (int c = 0; c < cols; ++c) live |= nonzero(row[c]);
  }
  bits[cell] = live ? 1 : 0;
}

constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
scan_warp_per_cell(const float* __restrict__ x, long long ld,
                   int* __restrict__ bits, int M, int N, int gr, int gc,
                   int Mc, int Nc) {
  const int lane = threadIdx.x & 31;
  const long long cell =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= (long long)Mc * Nc) return;  // uniform across the warp
  const int ci = (int)(cell / Nc);
  const int cj = (int)(cell - (long long)ci * Nc);
  const int r0 = ci * gr, c0 = cj * gc;
  const int rows = min(gr, M - r0), cols = min(gc, N - c0);
  const int n_el = rows * cols;
  bool live = false;
  for (int e = lane; e < n_el; e += 32) {
    const int r = e / cols;
    const int c = e - r * cols;
    live |= nonzero(x[(long long)(r0 + r) * ld + c0 + c]);
  }
  const bool any = __any_sync(0xffffffffu, live);
  if (lane == 0) bits[cell] = any ? 1 : 0;
}

}  // namespace

// x: (M, N) float32 with row stride ld (elements) and unit column stride.
// bits: (ceil(M/gr), ceil(N/gc)) int32, every cell written.
// Returns the cudaError_t of the launch.
extern "C" int bitmap_scan_launch(const float* x, long long ld, int* bits,
                                  int M, int N, int gr, int gc,
                                  void* stream) {
  if (gr < 1 || gc < 1 || M < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const int Mc = (M + gr - 1) / gr;
  const int Nc = (N + gc - 1) / gc;
  const long long cells = (long long)Mc * Nc;
  if (cells == 0) return 0;
  const bool per_thread = (long long)gr * gc <= kThreadCell;
  const long long per_block = per_thread ? kThreads : kWarpsPerBlock;
  const long long blocks = (cells + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (per_thread) {
    scan_thread_per_cell<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(x, ld, bits, M, N, gr, gc,
                                                   Mc, Nc);
  } else {
    scan_warp_per_cell<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(x, ld, bits, M, N, gr, gc,
                                                 Mc, Nc);
  }
  return (int)cudaGetLastError();
}
