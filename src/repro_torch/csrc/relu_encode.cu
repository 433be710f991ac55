// Fused ReLU + block-bitmap encode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/relu_encode.py:_relu_encode_kernel
// (launched by relu_encode_kernel): y = max(z, 0) and, for every (gr, gc)
// cell of the (M, N) activation, bit = any(y > 0).
//
// Bound on the H100: memory.  Each element is read once and written once
// (8 bytes), the bitmap adds 4 bytes per cell; there is no arithmetic to
// speak of.  Design: one warp per bitmap cell.  The warp's lanes stride over
// the cell's elements (16-byte float4 loads and stores when every row of
// every cell is 16-byte aligned), and __any_sync reduces the cell's bit in
// registers, so the bitmap costs no second pass over the activation.  The
// ragged edge (M % gr, N % gc) is masked here, so the caller makes no padded
// copy of the activation.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// v <= 0 is false for NaN, so a NaN propagates as it does through
// jnp.maximum(z, 0) in the reference.
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
relu_encode_kernel(const float* __restrict__ z, float* __restrict__ y,
                   int* __restrict__ bits, int M, int N, int gr, int gc,
                   int Mc, int Nc, int vec) {
  const int lane = threadIdx.x & 31;
  const long long cell =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= (long long)Mc * Nc) return;  // uniform across the warp
  const int ci = (int)(cell / Nc);
  const int cj = (int)(cell - (long long)ci * Nc);
  const int r0 = ci * gr, c0 = cj * gc;
  const int rows = min(gr, M - r0), cols = min(gc, N - c0);
  bool live = false;
  if (vec) {
    const int cols4 = cols >> 2;
    const int n_el = rows * cols4;
    for (int e = lane; e < n_el; e += 32) {
      const int r = e / cols4;
      const int c = (e - r * cols4) << 2;
      const long long idx = (long long)(r0 + r) * N + c0 + c;
      float4 v = *reinterpret_cast<const float4*>(z + idx);
      v.x = relu(v.x);
      v.y = relu(v.y);
      v.z = relu(v.z);
      v.w = relu(v.w);
      *reinterpret_cast<float4*>(y + idx) = v;
      live |= (v.x > 0.f) | (v.y > 0.f) | (v.z > 0.f) | (v.w > 0.f);
    }
  } else {
    const int n_el = rows * cols;
    for (int e = lane; e < n_el; e += 32) {
      const int r = e / cols;
      const int c = e - r * cols;
      const long long idx = (long long)(r0 + r) * N + c0 + c;
      const float v = relu(z[idx]);
      y[idx] = v;
      live |= v > 0.f;
    }
  }
  const bool any = __any_sync(0xffffffffu, live);
  if (lane == 0) bits[cell] = any ? 1 : 0;
}

}  // namespace

// z, y: (M, N) float32, row-major.  bits: (ceil(M/gr), ceil(N/gc)) int32.
// vec = 1 only when gc % 4 == 0, N % 4 == 0 and z, y are 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int relu_encode_launch(const float* z, float* y, int* bits, int M,
                                  int N, int gr, int gc, int vec,
                                  void* stream) {
  const int Mc = (M + gr - 1) / gr;
  const int Nc = (N + gc - 1) / gc;
  const long long cells = (long long)Mc * Nc;
  if (cells == 0) return 0;
  const long long blocks = (cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  relu_encode_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(z, y, bits, M, N, gr, gc, Mc,
                                               Nc, vec);
  return (int)cudaGetLastError();
}
