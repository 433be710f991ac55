// The cell-bitmap encoder shared by K1 (relu_encode.cu) and K5
// (bitmap_scan.cu), for Hopper (sm_90a).
//
// Reads an (M, N) float32 operand x (row stride ld, unit column stride) and
// writes the (ceil(M/gr), ceil(N/gc)) int32 bitmap of its (gr, gc) cells.
// With kRelu it also writes y = relu(x) in x's layout, and a cell's bit is
//   any(y > 0) && !any(isnan(y))                      (K1)
// else
//   any(|x| > 0) && !any(isnan(x))                    (K5)
// as the reference's max-reduce gives them: jnp.max carries a NaN, and
// NaN > 0 is false, so a cell that holds a NaN is 0 whatever else it holds.
// Both flags are reduced in registers in the same pass.
//
// Bound on the H100: memory (4 bytes in per element, 4 more out with kRelu,
// 4 per cell for the bitmap).  So every path moves 16 bytes a lane where the
// layout allows, neighbouring lanes on neighbouring addresses, and keeps
// every lane busy.  The host picks the path from the shape, the cell and the
// alignment alone (kernels/relu_encode.py:encode_plan) and this header
// checks what it was given:
//   quads     gr == 1, gc in {1, 2, 4}: a lane takes 4 consecutive elements
//             (one float4 load, one float4 store) and writes 4/gc bits (one
//             int4 store at gc == 1).  A contiguous operand whose rows hold
//             whole cells is walked flat, as one row of M*N, so N need not
//             be a multiple of 4: the last M*N % 4 elements (whole cells)
//             take one thread per cell;
//   segments  gr == 1, gc = 4 L with L in {2, 4, 8, 16, 32}: L lanes share a
//             cell, 32/L cells a warp; the flags are OR-reduced with
//             __shfl_xor_sync inside each segment of L lanes and its first
//             lane writes the bit;
//   warp      any other cell of more than kThreadCell elements (gr > 1,
//             gc > 128, gc not a power of two, or rows not 16-byte aligned):
//             a warp per cell, float4 loads where rows allow;
//   thread    any other cell (odd N, unaligned pointers, (4, 1)): a thread
//             per cell, scalar and exact.
// The ragged edge (M % gr, N % gc) is masked here, so the caller makes no
// padded copy.  Every path is a grid-stride loop over a grid the host sizes
// to the card, in place of one block per few cells.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cell_encode {

// Paths, numbered as kernels/relu_encode.py:PATH_IDS numbers them.
enum { kQuads = 0, kSegments = 1, kWarp = 2, kThread = 3 };

constexpr int kThreads = 256;
constexpr int kThreadCell = 8;       // thread path: elements per cell at most
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxIndex = 0x7fffffffLL;

struct Args {
  const float* x;   // rows of `width` elements, row stride ld
  float* y;         // relu(x) in x's layout (kRelu), else null
  int* bits;        // (Mc, Nc) int32, row-major
  unsigned rows, width;
  long long ld;
  int gr, gc;
  unsigned Mc, Nc;
};

// v <= 0 is false for NaN, so a NaN propagates as it does through
// jnp.maximum(z, 0) in the reference.
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

// Bit 0: the element is live; bit 1: it is NaN.  ORed over a cell, the
// cell's bit is 1 exactly when the result is 1.
template <bool kRelu>
__device__ __forceinline__ unsigned flags(float& v) {
  if (kRelu) v = relu(v);
  const bool live = kRelu ? v > 0.f : fabsf(v) > 0.f;
  return (unsigned)live | ((unsigned)(v != v) << 1);
}

__device__ __forceinline__ int bit_of(unsigned f) { return f == 1u ? 1 : 0; }

template <bool kRelu>
__device__ __forceinline__ unsigned take4(const Args& p, long long at) {
  float4 v = *reinterpret_cast<const float4*>(p.x + at);
  const unsigned f = flags<kRelu>(v.x) | (flags<kRelu>(v.y) << 2) |
                     (flags<kRelu>(v.z) << 4) | (flags<kRelu>(v.w) << 6);
  if (kRelu) *reinterpret_cast<float4*>(p.y + at) = v;
  return f;   // element e's flags at bits 2e, 2e + 1
}

template <bool kRelu>
__device__ __forceinline__ unsigned take1(const Args& p, long long at) {
  float v = p.x[at];
  const unsigned f = flags<kRelu>(v);
  if (kRelu) p.y[at] = v;
  return f;
}

// The four elements' flags of take4 ORed into one cell's.
__device__ __forceinline__ unsigned fold4(unsigned f) {
  return (f | (f >> 2) | (f >> 4) | (f >> 6)) & 3u;
}

template <bool kRelu, int kGc>
__device__ __forceinline__ void quads(const Args& p) {
  const unsigned wq = p.width >> 2;
  const unsigned nq = p.rows * wq;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  for (unsigned q = t; q < nq; q += gridDim.x * blockDim.x) {
    const unsigned r = q / wq;
    const unsigned c = (q - r * wq) << 2;
    const unsigned f = take4<kRelu>(p, (long long)r * p.ld + c);
    int* b = p.bits + (long long)r * p.Nc + c / kGc;
    if constexpr (kGc == 1) {
      *reinterpret_cast<int4*>(b) =
          make_int4(bit_of(f & 3u), bit_of((f >> 2) & 3u),
                    bit_of((f >> 4) & 3u), bit_of((f >> 6) & 3u));
    } else if constexpr (kGc == 2) {
      *reinterpret_cast<int2*>(b) = make_int2(
          bit_of((f | (f >> 2)) & 3u), bit_of(((f >> 4) | (f >> 6)) & 3u));
    } else {
      *b = bit_of(fold4(f));
    }
  }
  // A flat walk (rows == 1) ends in width % 4 elements, whole cells since
  // gc divides both 4 and width: one thread per cell.
  if (t < (p.width & 3u) / kGc) {
    const unsigned c0 = (wq << 2) + t * kGc;
    unsigned f = 0;
#pragma unroll
    for (int e = 0; e < kGc; ++e) f |= take1<kRelu>(p, c0 + e);
    p.bits[c0 / kGc] = bit_of(f);
  }
}

template <bool kRelu, int kLanes>
__device__ __forceinline__ void segments(const Args& p) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned slots = p.rows * p.Nc * kLanes;
  const unsigned step = gridDim.x * blockDim.x;
  // Warp-uniform bounds: every lane reaches the shuffles.
  for (unsigned base = blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
       base < slots; base += step) {
    const unsigned t = base + lane;
    const unsigned cell = t / kLanes;
    unsigned f = 0;
    if (t < slots) {
      const unsigned r = cell / p.Nc;
      const unsigned c = (cell - r * p.Nc) * (4 * kLanes) + (t % kLanes) * 4;
      if (c < p.width) f = fold4(take4<kRelu>(p, (long long)r * p.ld + c));
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) f |= __shfl_xor_sync(kFull, f, o);
    if (t < slots && t % kLanes == 0) p.bits[cell] = bit_of(f);
  }
}

template <bool kRelu, bool kVec>
__device__ __forceinline__ void warps(const Args& p) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned cells = p.Mc * p.Nc;
  const unsigned per_block = blockDim.x >> 5;
  for (unsigned cell = blockIdx.x * per_block + (threadIdx.x >> 5);
       cell < cells; cell += gridDim.x * per_block) {   // warp-uniform
    const unsigned ci = cell / p.Nc;
    const unsigned cj = cell - ci * p.Nc;
    const unsigned r0 = ci * p.gr, c0 = cj * p.gc;
    const unsigned rows = min((unsigned)p.gr, p.rows - r0);
    const unsigned cols = min((unsigned)p.gc, p.width - c0);
    const unsigned w = kVec ? cols >> 2 : cols;
    const unsigned n_el = rows * w;
    unsigned f = 0;
    for (unsigned e = lane; e < n_el; e += 32) {
      const unsigned r = e / w;
      const unsigned c = e - r * w;
      const long long at = (long long)(r0 + r) * p.ld + c0 + (kVec ? c << 2 : c);
      f |= kVec ? fold4(take4<kRelu>(p, at)) : take1<kRelu>(p, at);
    }
    f = __reduce_or_sync(kFull, f);
    if (lane == 0) p.bits[cell] = bit_of(f);
  }
}

template <bool kRelu>
__device__ __forceinline__ void threads(const Args& p) {
  const unsigned cells = p.Mc * p.Nc;
  for (unsigned cell = blockIdx.x * blockDim.x + threadIdx.x; cell < cells;
       cell += gridDim.x * blockDim.x) {
    const unsigned ci = cell / p.Nc;
    const unsigned cj = cell - ci * p.Nc;
    const unsigned r0 = ci * p.gr, c0 = cj * p.gc;
    const unsigned rows = min((unsigned)p.gr, p.rows - r0);
    const unsigned cols = min((unsigned)p.gc, p.width - c0);
    unsigned f = 0;
    for (unsigned r = 0; r < rows; ++r)
      for (unsigned c = 0; c < cols; ++c)
        f |= take1<kRelu>(p, (long long)(r0 + r) * p.ld + c0 + c);
    p.bits[cell] = bit_of(f);
  }
}

// kWidth: the cell width gc on the quads path, the lanes per cell on the
// segments path, 4 for float4 loads on the warp path (else 1).
template <bool kRelu, int kPath, int kWidth>
__global__ void __launch_bounds__(kThreads) encode_kernel(const Args p) {
  if constexpr (kPath == kQuads) {
    quads<kRelu, kWidth>(p);
  } else if constexpr (kPath == kSegments) {
    segments<kRelu, kWidth>(p);
  } else if constexpr (kPath == kWarp) {
    warps<kRelu, kWidth == 4>(p);
  } else {
    threads<kRelu>(p);
  }
}

inline bool aligned16(const void* ptr) {
  return ptr == nullptr || ((uintptr_t)ptr & 15u) == 0;
}

// One launch of the encoder on the plan the host chose (path, lanes per
// cell on the segments path, vector loads on the warp path, flat walk on
// the quads path, grid).  x: (M, N) with row stride ld; y: null, or (M, N)
// in x's layout; bits: (ceil(M/gr), ceil(N/gc)) int32.  Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a plan that does
// not fit the operand.
template <bool kRelu>
int launch(const float* x, long long ld, float* y, int* bits, int M, int N,
           int gr, int gc, int path, int lanes, int vec, int flat, int grid,
           void* stream) {
  if (gr < 1 || gc < 1 || M < 0 || N < 0 || grid < 1 || (M > 1 && ld < N) ||
      (kRelu && y == nullptr) || (long long)M * N > kMaxIndex)
    return (int)cudaErrorInvalidValue;
  const long long Mc = (M + gr - 1) / gr, Nc = (N + gc - 1) / gc;
  if (Mc * Nc == 0) return 0;
  Args p;
  p.x = x;
  p.y = y;
  p.bits = bits;
  p.gr = gr;
  p.gc = gc;
  p.rows = (unsigned)M;
  p.width = (unsigned)N;
  p.ld = ld;
  p.Mc = (unsigned)Mc;
  p.Nc = (unsigned)Nc;
  const bool ptrs16 = aligned16(x) && aligned16(y);
  const bool rows16 = ptrs16 && N % 4 == 0 && ld % 4 == 0;
  bool ok;
  if (path == kQuads) {
    ok = gr == 1 && (gc == 1 || gc == 2 || gc == 4) &&
         (flat ? ptrs16 && N % gc == 0 && (ld == N || M == 1) : rows16);
    if (ok && flat) {   // one row of M * N
      p.rows = M > 0 ? 1u : 0u;
      p.width = (unsigned)((long long)M * N);
      p.ld = (long long)M * N;
      p.Mc = p.rows;
      p.Nc = p.width / gc;
    }
  } else if (path == kSegments) {
    ok = gr == 1 && rows16 && gc == 4 * lanes &&
         (lanes == 2 || lanes == 4 || lanes == 8 || lanes == 16 ||
          lanes == 32) &&
         Mc * Nc * lanes <= kMaxIndex;
  } else if (path == kWarp) {
    ok = (long long)gr * gc > kThreadCell &&
         (!vec || (rows16 && gc % 4 == 0));
  } else {
    ok = path == kThread && (long long)gr * gc <= kThreadCell;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (path == kQuads) {
    switch (gc) {
      case 1: encode_kernel<kRelu, kQuads, 1><<<grid, kThreads, 0, st>>>(p); break;
      case 2: encode_kernel<kRelu, kQuads, 2><<<grid, kThreads, 0, st>>>(p); break;
      default: encode_kernel<kRelu, kQuads, 4><<<grid, kThreads, 0, st>>>(p); break;
    }
  } else if (path == kSegments) {
    switch (lanes) {
      case 2: encode_kernel<kRelu, kSegments, 2><<<grid, kThreads, 0, st>>>(p); break;
      case 4: encode_kernel<kRelu, kSegments, 4><<<grid, kThreads, 0, st>>>(p); break;
      case 8: encode_kernel<kRelu, kSegments, 8><<<grid, kThreads, 0, st>>>(p); break;
      case 16: encode_kernel<kRelu, kSegments, 16><<<grid, kThreads, 0, st>>>(p); break;
      default: encode_kernel<kRelu, kSegments, 32><<<grid, kThreads, 0, st>>>(p); break;
    }
  } else if (path == kWarp) {
    if (vec) {
      encode_kernel<kRelu, kWarp, 4><<<grid, kThreads, 0, st>>>(p);
    } else {
      encode_kernel<kRelu, kWarp, 1><<<grid, kThreads, 0, st>>>(p);
    }
  } else {
    encode_kernel<kRelu, kThread, 1><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace cell_encode
