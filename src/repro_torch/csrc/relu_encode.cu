// Fused ReLU + block-bitmap encode (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/relu_encode.py:_relu_encode_kernel
// (launched by relu_encode_kernel): y = max(z, 0) and, for every (gr, gc)
// cell of the (M, N) activation, bit = any(y > 0) && !any(isnan(y)) (the
// reference's max over the cell carries a NaN, and NaN > 0 is false).
//
// Bound on the H100: memory.  Each element is read once and written once
// (8 bytes), the bitmap adds 4 bytes per cell; there is no arithmetic to
// speak of.  The encoder of cell_encode.cuh does the work with kRelu set:
// 16 bytes a lane, several cells a lane at gran (1, 1)-(1, 4), several
// lanes a cell at (1, 8)-(1, 128), a warp or a thread per cell elsewhere,
// on the path kernels/relu_encode.py:encode_plan chose.
#include "cell_encode.cuh"

// z, y: (M, N) float32, contiguous.  bits: (ceil(M/gr), ceil(N/gc)) int32.
// path, lanes, vec, flat, grid: the plan (cell_encode::launch).  Returns the
// cudaError_t of the launch.
extern "C" int relu_encode_launch(const float* z, float* y, int* bits, int M,
                                  int N, int gr, int gc, int path, int lanes,
                                  int vec, int flat, int grid, void* stream) {
  return cell_encode::launch<true>(z, N, y, bits, M, N, gr, gc, path, lanes,
                                   vec, flat, grid, stream);
}
