// Grouped block-sparse GEMM with the sigma-prime / bitmap-emit epilogue,
// for Hopper (sm_90a).  One device function serves both schedules:
//
//   compact    replaces repro/kernels/masked_matmul.py:_gmm_compact_kernel
//              (grouped_compact_masked_matmul_kernel): one block per queue
//              slot s < min(n_live, cap); the slot names the output tile.
//   predicated replaces repro/kernels/masked_matmul.py:_gmm_kernel
//              (grouped_masked_matmul_kernel): one block per (g, i, j) tile
//              of the full grid; a tile whose out_mask bit is 0 keeps the
//              zeros the caller filled in.  At G = 1 it also replaces the
//              2-D _mm_kernel / _mm_epilogue_kernel (masked_matmul_kernel).
//   compact_out replaces the 2-D _mm_compact_kernel /
//              _mm_compact_epilogue_kernel (compact_masked_matmul_kernel):
//              G = 1, one block per queue slot s < n_active, and the tile
//              goes to slot s of an (S, bm, bn) compacted output; slots
//              s >= n_active keep the caller's zeros.
//
// For its tile (g, i, j) a block computes
//   out = sum over k blocks with a_mask[g,i,kb] && b_mask[g,kb,j] of A.B,
// in full float32 FMA (no TF32, no tensor cores), then the epilogue of
// repro/kernels/masked_matmul.py:_apply_epilogue: out *= mult (sigma-prime)
// and, over the post-sigma-prime values, bits[g, m/er, n/ec] = any(|out|>0).
//
// Bound on the H100: operations.  Work is 2 * (live tile rows) * (live tile
// cols) * (live k-block length) float32 FLOPs against 67 TFLOP/s outside the
// tensor cores.  Design:
//   * A mask tile is not a hardware tile (blocks such as (8, 16, 8) and
//     ragged edges occur).  A block owns a 128 x 128 register tile (256
//     threads, 8 x 8 outputs each); gridDim.y covers a mask tile larger than
//     that, and a smaller one leaves rows/cols idle.  Every load and store is
//     bounds-checked against the mask tile and M/K/N, so the caller passes
//     unpadded operands.
//   * K advances in chunks of 16 through shared memory; the operand masks are
//     read once per bk block and a dead block is skipped before any load.
//   * A and B are taken with explicit strides, so the weight-gradient GEMM
//     reads patches^T and the head GEMMs read x^T without a transposed copy.
//     The shared-memory fill follows whichever stride is 1.
//   * Output tiles and their bits are written straight to their (g, i, j)
//     place in the caller's zero-filled output: there is no compacted buffer
//     and no scatter.  Bits are set by plain stores of 1 (all writers agree),
//     so no atomics are needed.
//   * Queue overflow is decided on the device: with a live-count pointer the
//     compact launch exits when n_live > cap and the predicated launch exits
//     when n_live <= cap, so the caller launches both without a host sync.
// One block per output tile leaves a weight-gradient GEMM with few output
// tiles (conv2: 5 tiles, K = 401,408) on a handful of SMs; split-K is the
// expected first redesign.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 128;
constexpr int TN = 128;
constexpr int TK = 16;
constexpr int kThreads = 256;

enum { kPredicated = 0, kCompact = 1, kCompactOut = 2 };

struct GemmArgs {
  const float* A;
  long long sAg, sAm, sAk;
  const float* B;
  long long sBg, sBk, sBn;
  float* out;          // (G, M, N), or (cap, bm, bn) in compact_out mode;
                       // contiguous, zero-filled
  int* bits;           // (G, Mc, Nc) contiguous, zero-filled, or null
  const int* out_mask; // (G, Mb, Nb) or null (all live)
  const int* a_mask;   // (G, Mb, Kb) or null
  const int* b_mask;   // (G, Kb, Nb) or null
  const float* mult;   // (G, M, N) or null
  const int* q_fi;     // (cap,) fused row g * Mb + i of each queue slot
  const int* q_jj;     // (cap,)
  const int* n_live;   // (1,) or null
  int cap;
  int G, M, K, N;
  int bm, bk, bn, er, ec;
  int Mb, Kb, Nb, Mc, Nc;
  int nsub_n;
  int mode;
  int a_kcontig, b_ncontig;
};

// kOutCompact selects the compact_out mode at compile time, so the two
// grouped modes compile to the code they had before it existed.  As a
// runtime branch in the store loop it cut them to 176 registers and made
// them ~19% slower (VGG16 step on an H100: 281 against 237 ms of GEMMs).
template <bool kOutCompact>
__global__ void __launch_bounds__(kThreads)
masked_gemm_kernel(const GemmArgs p) {
  int g, i, j;
  if (kOutCompact || p.mode == kCompact) {
    const int nl = *p.n_live;
    // overflow: the predicated launch owns it (compact_out has none)
    if (!kOutCompact && nl > p.cap) return;
    const int s = blockIdx.x;
    if (s >= nl) return;
    const int fi = p.q_fi[s];
    g = fi / p.Mb;
    i = fi - g * p.Mb;
    j = p.q_jj[s];
  } else {
    if (p.n_live != nullptr && *p.n_live <= p.cap) return;
    const long long t = blockIdx.x;
    if (p.out_mask != nullptr && p.out_mask[t] == 0) return;
    const long long per_g = (long long)p.Mb * p.Nb;
    g = (int)(t / per_g);
    const int rem = (int)(t - g * per_g);
    i = rem / p.Nb;
    j = rem - i * p.Nb;
  }
  const int sub_i = blockIdx.y / p.nsub_n;
  const int sub_j = blockIdx.y - sub_i * p.nsub_n;
  const int m0 = i * p.bm + sub_i * TM;
  const int m_end = min(min(i * p.bm + p.bm, m0 + TM), p.M);
  const int n0 = j * p.bn + sub_j * TN;
  const int n_end = min(min(j * p.bn + p.bn, n0 + TN), p.N);
  if (m0 >= m_end || n0 >= n_end) return;

  __shared__ float As[TK][TM + 1];
  __shared__ float Bs[TK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const float* Ag = p.A + (long long)g * p.sAg;
  const float* Bg = p.B + (long long)g * p.sBg;
  const int* am = p.a_mask ? p.a_mask + ((long long)g * p.Mb + i) * p.Kb
                           : nullptr;
  const int* bmk = p.b_mask ? p.b_mask + (long long)g * p.Kb * p.Nb + j
                            : nullptr;
  for (int kb = 0; kb < p.Kb; ++kb) {
    // Uniform across the block: the whole block skips a dead k block.
    if (am != nullptr && am[kb] == 0) continue;
    if (bmk != nullptr && bmk[(long long)kb * p.Nb] == 0) continue;
    const int k_lo = kb * p.bk;
    const int k_hi = min(k_lo + p.bk, p.K);
    for (int k0 = k_lo; k0 < k_hi; k0 += TK) {
#pragma unroll
      for (int q = 0; q < TM * TK / kThreads; ++q) {
        const int e = tid + q * kThreads;
        int mm, kk;
        if (p.a_kcontig) {
          kk = e % TK;
          mm = e / TK;
        } else {
          mm = e % TM;
          kk = e / TM;
        }
        const int m = m0 + mm;
        const int k = k0 + kk;
        As[kk][mm] = (m < m_end && k < k_hi)
                         ? Ag[(long long)m * p.sAm + (long long)k * p.sAk]
                         : 0.f;
      }
#pragma unroll
      for (int q = 0; q < TN * TK / kThreads; ++q) {
        const int e = tid + q * kThreads;
        int nn, kk;
        if (p.b_ncontig) {
          nn = e % TN;
          kk = e / TN;
        } else {
          kk = e % TK;
          nn = e / TK;
        }
        const int n = n0 + nn;
        const int k = k0 + kk;
        Bs[kk][nn] = (n < n_end && k < k_hi)
                         ? Bg[(long long)k * p.sBk + (long long)n * p.sBn]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= m_end) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n >= n_end) continue;
      const long long o = ((long long)g * p.M + m) * p.N + n;
      float v = acc[r][c];
      if (p.mult != nullptr) v *= p.mult[o];
      if (kOutCompact) {
        p.out[((long long)blockIdx.x * p.bm + (m - i * p.bm)) * p.bn +
              (n - j * p.bn)] = v;
      } else {
        p.out[o] = v;
      }
      if (p.bits != nullptr && fabsf(v) > 0.f)
        p.bits[((long long)g * p.Mc + m / p.er) * p.Nc + n / p.ec] = 1;
    }
  }
}

}  // namespace

// mode 0 = predicated (grid over every (g, i, j) tile), 1 = compact (grid
// over the cap queue slots; needs q_fi, q_jj, n_live), 2 = compact_out (as
// compact, at G = 1, into the (cap, bm, bn) compacted output).  With mode 0
// and a non-null n_live the launch is the compact path's overflow fallback
// and runs only when n_live > cap.  er/ec are ignored when bits is null.
// Returns the cudaError_t of the launch.
extern "C" int masked_gemm_launch(
    const float* A, long long sAg, long long sAm, long long sAk,
    const float* B, long long sBg, long long sBk, long long sBn, float* out,
    int* bits, const int* out_mask, const int* a_mask, const int* b_mask,
    const float* mult, const int* q_fi, const int* q_jj, const int* n_live,
    int cap, int G, int M, int K, int N, int bm, int bk, int bn, int er,
    int ec, int mode, void* stream) {
  GemmArgs p;
  p.A = A;
  p.sAg = sAg;
  p.sAm = sAm;
  p.sAk = sAk;
  p.B = B;
  p.sBg = sBg;
  p.sBk = sBk;
  p.sBn = sBn;
  p.out = out;
  p.bits = bits;
  p.out_mask = out_mask;
  p.a_mask = a_mask;
  p.b_mask = b_mask;
  p.mult = mult;
  p.q_fi = q_fi;
  p.q_jj = q_jj;
  p.n_live = n_live;
  p.cap = cap;
  p.G = G;
  p.M = M;
  p.K = K;
  p.N = N;
  p.bm = bm;
  p.bk = bk;
  p.bn = bn;
  p.er = bits ? er : 1;
  p.ec = bits ? ec : 1;
  p.Mb = (M + bm - 1) / bm;
  p.Kb = (K + bk - 1) / bk;
  p.Nb = (N + bn - 1) / bn;
  p.Mc = (M + p.er - 1) / p.er;
  p.Nc = (N + p.ec - 1) / p.ec;
  p.nsub_n = (bn + TN - 1) / TN;
  p.mode = mode;
  p.a_kcontig = sAk == 1;
  p.b_ncontig = sBn == 1;
  const long long nsub = (long long)((bm + TM - 1) / TM) * p.nsub_n;
  const long long tiles =
      mode == kPredicated ? (long long)G * p.Mb * p.Nb : (long long)cap;
  if (tiles == 0 || M == 0 || N == 0) return 0;
  if (tiles > 0x7fffffffLL || nsub > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (mode != kPredicated && (q_fi == nullptr || q_jj == nullptr ||
                              n_live == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == kCompactOut && (G != 1 || bits != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)tiles, (unsigned)nsub);
  if (mode == kCompactOut) {
    masked_gemm_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  } else {
    masked_gemm_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
