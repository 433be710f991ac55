// Block any-nonzero bitmap of signed data (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitmap_scan.py:_bitmap_scan_kernel
// (launched by bitmap_scan_kernel): for every (gr, gc) cell of the (M, N)
// signed tensor x, bit = any(|x| > 0) && !any(isnan(x)) (the reference's
// max over the cell carries a NaN, and NaN > 0 is false).  It runs where no
// ReLU produced the bitmap for free: the opt-in scan of raw signed inputs
// (the image before the first conv, the pooled features before the head).
//
// Bound on the H100: memory.  Each element is read once and each cell's bit
// written once; there is no arithmetic to speak of.  At the first conv's
// input (401,408 x 3 at gran (1, 1)) that is 4.8 MB in and 4.8 MB out, about
// 3 us at 3.35 TB/s, so launch latency dominates.  The encoder of
// cell_encode.cuh does the work without the ReLU store, on the path
// kernels/relu_encode.py:encode_plan chose: a contiguous image at (1, 1) is
// walked flat, 4 elements and one int4 of bits a lane, though N = 3.
#include "cell_encode.cuh"

// x: (M, N) float32 with row stride ld (elements) and unit column stride.
// bits: (ceil(M/gr), ceil(N/gc)) int32, every cell written.  path, lanes,
// vec, flat, grid: the plan (cell_encode::launch).  Returns the cudaError_t
// of the launch.
extern "C" int bitmap_scan_launch(const float* x, long long ld, int* bits,
                                  int M, int N, int gr, int gc, int path,
                                  int lanes, int vec, int flat, int grid,
                                  void* stream) {
  return cell_encode::launch<false>(x, ld, nullptr, bits, M, N, gr, gc, path,
                                    lanes, vec, flat, grid, stream);
}
