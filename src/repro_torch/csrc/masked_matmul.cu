// Grouped block-sparse GEMM with the sigma-prime / bitmap-emit epilogue,
// for Hopper (sm_90a).  One launcher serves every schedule:
//
//   compact    replaces repro/kernels/masked_matmul.py:_gmm_compact_kernel
//              (grouped_compact_masked_matmul_kernel): the tiles named by
//              queue slots s < min(n_live, cap).
//   predicated replaces repro/kernels/masked_matmul.py:_gmm_kernel
//              (grouped_masked_matmul_kernel): every (g, i, j) tile whose
//              out_mask bit is set; a dead tile keeps the zeros the caller
//              filled in.  At G = 1 it also replaces the 2-D _mm_kernel /
//              _mm_epilogue_kernel (masked_matmul_kernel).
//   compact_out replaces the 2-D _mm_compact_kernel /
//              _mm_compact_epilogue_kernel (compact_masked_matmul_kernel):
//              G = 1, the tile of queue slot s < n_active goes to slot s of
//              an (S, bm, bn) compacted output; the other slots keep zeros.
//
// For its tile (g, i, j) every path computes
//   out = sum over k blocks with a_mask[g,i,kb] && b_mask[g,kb,j] of A.B,
// in full float32 FMA (no TF32, no tensor cores), then the epilogue of
// repro/kernels/masked_matmul.py:_apply_epilogue: out *= mult (sigma-prime)
// and, over the post-sigma-prime values, bits[g, m/er, n/ec] = any(|out|>0)
// and no NaN in the cell (the reference's max over the cell carries a NaN,
// and NaN > 0 is false).
// Only live tiles are written, straight to their (g, i, j) place in the
// caller's zero-filled output (no compacted buffer, no scatter); bits are
// plain stores of 1 (all writers agree).  A NaN is rare, so it costs the
// store loop one flag store: an emitting launch that meets a NaN output
// sets a device flag, and emit_nan_fixup_kernel, launched after every
// emitting launch, returns at once when the flag is clear, and otherwise
// clears the bit of every cell whose output holds a NaN.  Queue overflow is
// decided on the device: the compact launch exits when n_live > cap and the
// predicated fallback when n_live <= cap, so the caller launches both with
// no sync.
//
// The caller (kernels/masked_matmul.py) picks a path and a split count from
// the shape (G, M, K, N) and the mask block alone, never from the masks,
// the capacity or n_live, so every schedule of one shape sums in one order:
//   standard   a block owns a 128 x 128 register tile (256 threads, 8 x 8
//              outputs each) and covers its mask tile with gridDim.y; K
//              advances in chunks of 16 through shared memory; a dead k
//              block is skipped before any load; A and B are read through
//              their strides (patches^T needs no copy) and the shared-memory
//              fill follows whichever stride is 1.  253 registers: one
//              block per SM.
//   group rows the degenerate per-group tiles of depthwise FP and dX GEMMs
//              (K <= 64 / N, N <= 8, one column tile): a block takes 32
//              groups, one per lane, because the group is the unit stride
//              of A (patches regrouped by a view), and 64 or 32 rows; each
//              thread owns the <= 8-wide output row of one (g, m).  B waits
//              in shared memory; the output tile is staged there so that
//              stores, the sigma-prime reads and the bits walk m coalesced.
//              In compact mode a pre-pass marks the queue's tiles in a
//              (G, Mb, Nb) membership bitmap, read in place of out_mask.
//   group k    degenerate per-group weight gradients (one (M <= 32) x
//              (N <= 8) tile per group, long K): 32 groups per block, the
//              8 warps split each k block, and the 8 partial sums are added
//              in warp order through shared memory.
// Split-K: a grid smaller than two waves gets `splits` slices of whole mask
// k blocks on blockIdx.z (split z takes k blocks
// [z*Kb/S, (z+1)*Kb/S)).  Each slice writes its raw partial tile into a
// (S, G, M, N) workspace; the reduce launch enumerates the tiles exactly as
// the GEMM launch did, adds the S partials in a fixed order (no atomics, so
// the bits do not change from run to run), applies the epilogue and writes
// the live tiles.  The reduce is bound by bytes: S partials of every live
// output, read once (conv2's WG: 11.6 MB, 3.5 us at 3.35 TB/s), and it
// needs a few MB of loads in flight to approach that rate.  Its plan
// (kernels/masked_matmul.reduce_plan, from the shape and S alone) cuts the
// splits into C chunks; a thread takes one chunk of 4 adjacent outputs,
// reads it as float4 (where N, bn and the workspace allow) with a batch of
// loads issued before its adds, and sums it in split order; the C chunk
// sums are added in chunk order through shared memory.  Group k lays its
// blocks over the flat (G, M, N) workspace across the groups (each group's
// tile is 1-32 outputs); the standard path keeps one tile per grid x so
// that tile_of decides the schedule and the overflow on the device.
//
// Shadow build.  Compiled with -DREPRO_SHADOW (a second library, built by
// kernels/_build.py for analysis/kernel_sanitizer.py alone), every store to
// out and to the split-K workspace adds 1 to a per-element write counter,
// and every workspace load of an element never written adds 1 to a count of
// unwritten reads: the DOUBLE_WRITE and ACC_READ_BEFORE_WRITE checks.  The
// counters are armed with shadow_arm (below); without the macro the hooks
// are empty and the kernels compile to the default build's code.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 128;
constexpr int TN = 128;
constexpr int TK = 16;
constexpr int kThreads = 256;
constexpr int kLanes = 32;                    // group-major: groups / block
constexpr int kSubLanes = kThreads / kLanes;  // 8
constexpr int kRowsMaxKN = 64;                // group rows: K * N of B
constexpr int kRowsStage = 256;               // group rows: rows * N staged
constexpr int kRowsMaxRows = 64;
constexpr int kKMaxMN = 32;                   // group k: accumulators
constexpr int kReduceLoads = 8;               // reduce: loads in flight

constexpr int kFixupBlocks = 264;             // NaN fix-up: 2 per SM at most

enum { kPredicated = 0, kCompact = 1, kCompactOut = 2 };   // mode
enum { kStandard = 0, kGroupRows = 1, kGroupK = 2 };       // path

// Set by an emitting launch that wrote a NaN output; cleared by the last
// block of the fix-up launch that follows it in stream order.  One flag per
// device: emitting launches must be ordered on one stream, as the port
// issues every launch on PyTorch's current stream.
__device__ int g_emit_nan = 0;
__device__ unsigned g_fixup_done = 0;

#ifdef REPRO_SHADOW
// The armed buffers: writes of out[0, out_n) and ws[0, ws_n) counted per
// element; loads of ws elements whose count is 0 counted in *unwritten.
struct Shadow {
  const float* out;
  long long out_n;
  int* out_writes;
  const float* ws;
  long long ws_n;
  int* ws_writes;
  int* unwritten;
};
__device__ Shadow g_shadow;

__device__ __forceinline__ void shadow_count(const float* base, long long n,
                                             int* writes, const float* q) {
  if (writes != nullptr && q >= base && q < base + n)
    atomicAdd(&writes[q - base], 1);
}
__device__ __forceinline__ void shadow_out(const float* q) {
  shadow_count(g_shadow.out, g_shadow.out_n, g_shadow.out_writes, q);
}
__device__ __forceinline__ void shadow_ws_write(const float* q) {
  shadow_count(g_shadow.ws, g_shadow.ws_n, g_shadow.ws_writes, q);
}
__device__ __forceinline__ void shadow_ws_read(const float* q, int cnt) {
  const Shadow& s = g_shadow;
  if (s.ws_writes == nullptr) return;
  for (int e = 0; e < cnt; ++e)
    if (q + e >= s.ws && q + e < s.ws + s.ws_n &&
        atomicAdd(&s.ws_writes[q + e - s.ws], 0) == 0)
      atomicAdd(s.unwritten, 1);
}
#else
__device__ __forceinline__ void shadow_out(const float*) {}
__device__ __forceinline__ void shadow_ws_write(const float*) {}
__device__ __forceinline__ void shadow_ws_read(const float*, int) {}
#endif

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
  float* ws;           // (splits, G, M, N) partial sums when splits > 1
  int* member;         // (G, Mb, Nb) queue membership (group-major compact)
  int cap;
  int G, M, K, N;
  int bm, bk, bn, er, ec;
  int Mb, Kb, Nb, Mc, Nc;
  int nsub_n;
  int mode, path, splits, rows;
  int a_kcontig, b_ncontig;
  int r_chunks, r_quads, r_grid;  // the reduce plan (kernels/masked_matmul.py)
  bool r_vec;                     // the reduce reads ws as float4
  bool r_vec_out;                 // ... and mult and out, where r_vec
};

// The tile (g, i, j) of standard-path block t, or false when the block has
// nothing to write: past n_live, a dead out_mask bit, or the schedule that
// the overflow decision rules out.
__device__ __forceinline__ bool tile_of(const GemmArgs& p, long long t,
                                        int& g, int& i, int& j) {
  if (p.mode != kPredicated) {
    const int nl = *p.n_live;
    // overflow: the predicated launch owns it (compact_out has none)
    if (p.mode == kCompact && nl > p.cap) return false;
    if (t >= nl) return false;
    const int fi = p.q_fi[t];
    g = fi / p.Mb;
    i = fi - g * p.Mb;
    j = p.q_jj[t];
    return true;
  }
  if (p.n_live != nullptr && *p.n_live <= p.cap) return false;
  if (p.out_mask != nullptr && p.out_mask[t] == 0) return false;
  const long long per_g = (long long)p.Mb * p.Nb;
  g = (int)(t / per_g);
  const int rem = (int)(t - g * per_g);
  i = rem / p.Nb;
  j = rem - i * p.Nb;
  return true;
}

// Group-major paths: does this launch run at all (the overflow decision)?
__device__ __forceinline__ bool gm_runs(const GemmArgs& p) {
  if (p.mode == kCompact) return *p.n_live <= p.cap;
  return p.n_live == nullptr || *p.n_live > p.cap;
}

// Group-major paths: is tile (g, i, j) written?  Compact mode reads the
// queue's membership bitmap, predicated mode the out_mask.
__device__ __forceinline__ bool gm_live(const GemmArgs& p, int g, int i,
                                        int j) {
  const long long t = ((long long)g * p.Mb + i) * p.Nb + j;
  if (p.mode == kCompact) return p.member[t] != 0;
  return p.out_mask == nullptr || p.out_mask[t] != 0;
}

__device__ __forceinline__ bool kblock_live(const GemmArgs& p, int g, int i,
                                            int j, int kb) {
  if (p.a_mask != nullptr &&
      p.a_mask[((long long)g * p.Mb + i) * p.Kb + kb] == 0)
    return false;
  return p.b_mask == nullptr ||
         p.b_mask[((long long)g * p.Kb + kb) * p.Nb + j] != 0;
}

__device__ __forceinline__ void split_range(const GemmArgs& p, int z, int& lo,
                                            int& hi) {
  lo = (int)((long long)z * p.Kb / p.splits);
  hi = (int)((long long)(z + 1) * p.Kb / p.splits);
}

// The bitmap of one post-sigma-prime output: 1 for a live value; a NaN
// raises the flag for the fix-up launch.
__device__ __forceinline__ void emit_bit(const GemmArgs& p, int g, int m,
                                         int n, float v) {
  if (fabsf(v) > 0.f)
    p.bits[((long long)g * p.Mc + m / p.er) * p.Nc + n / p.ec] = 1;
  else if (v != v)
    g_emit_nan = 1;
}

// The epilogue of one output element: x mult, the store, the bitmap.
__device__ __forceinline__ void emit(const GemmArgs& p, long long o, int g,
                                     int m, int n, float v) {
  if (p.mult != nullptr) v *= p.mult[o];
  p.out[o] = v;
  shadow_out(&p.out[o]);
  if (p.bits != nullptr) emit_bit(p, g, m, n, v);
}

// The standard path.  kOutCompact selects the compact_out store and kSplit
// the raw partial store at compile time: as a runtime branch in the store
// loop, compact_out cut the grouped modes to 176 registers and made them
// ~19% slower (VGG16 step on an H100: 281 against 237 ms of GEMMs).
template <bool kOutCompact, bool kSplit>
__global__ void __launch_bounds__(kThreads)
masked_gemm_kernel(const GemmArgs p) {
  int g, i, j;
  if (!tile_of(p, blockIdx.x, g, i, j)) return;
  const int sub_i = blockIdx.y / p.nsub_n;
  const int sub_j = blockIdx.y - sub_i * p.nsub_n;
  const int m0 = i * p.bm + sub_i * TM;
  const int m_end = min(min(i * p.bm + p.bm, m0 + TM), p.M);
  const int n0 = j * p.bn + sub_j * TN;
  const int n_end = min(min(j * p.bn + p.bn, n0 + TN), p.N);
  if (m0 >= m_end || n0 >= n_end) return;
  int kb_lo = 0, kb_hi = p.Kb;
  if (kSplit) split_range(p, blockIdx.z, kb_lo, kb_hi);

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
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
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

  float* ws = kSplit ? p.ws + (long long)blockIdx.z * p.G * p.M * p.N
                     : nullptr;
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
      if (kSplit) {
        ws[o] = v;
        shadow_ws_write(&ws[o]);
        continue;
      }
      if (p.mult != nullptr) v *= p.mult[o];
      if (kOutCompact) {
        float* d = &p.out[((long long)blockIdx.x * p.bm + (m - i * p.bm)) *
                              p.bn + (n - j * p.bn)];
        *d = v;
        shadow_out(d);
      } else {
        p.out[o] = v;
        shadow_out(&p.out[o]);
      }
      if (p.bits != nullptr) emit_bit(p, g, m, n, v);
    }
  }
}

// Group-major rows: block (gc, mc) covers groups [32 gc, 32 gc + 32) and
// rows [rows * mc, rows * (mc + 1)); blockIdx.x = mc * gchunks + gc, so
// neighbouring blocks read neighbouring columns of the same patch rows.
__global__ void __launch_bounds__(kThreads)
group_rows_kernel(const GemmArgs p) {
  if (!gm_runs(p)) return;
  const int gchunks = (p.G + kLanes - 1) / kLanes;
  const int gc = blockIdx.x % gchunks;
  const int mc = blockIdx.x / gchunks;
  const int g0 = gc * kLanes;
  const int m0 = mc * p.rows;
  const int lane = threadIdx.x & (kLanes - 1);
  const int sl = threadIdx.x / kLanes;
  const int g = g0 + lane;
  const int kn = p.K * p.N;

  __shared__ float Bs[kRowsMaxKN][kLanes + 1];
  __shared__ float Os[kLanes][kRowsStage + 1];
  __shared__ unsigned char Ls[kLanes][kRowsMaxRows];
  for (int e = threadIdx.x; e < kLanes * kn; e += kThreads) {
    const int l = e & (kLanes - 1);
    const int q = e / kLanes;
    const int k = q / p.N;
    const int n = q - k * p.N;
    const int gg = g0 + l;
    Bs[q][l] = gg < p.G ? p.B[(long long)gg * p.sBg + (long long)k * p.sBk +
                              (long long)n * p.sBn]
                        : 0.f;
  }
  __syncthreads();

  const float* Ag = p.A + (long long)g * p.sAg;
  for (int r = sl; r < p.rows; r += kSubLanes) {
    const int m = m0 + r;
    const int i = m / p.bm;
    const bool live = g < p.G && m < p.M && gm_live(p, g, i, 0);
    Ls[lane][r] = live;
    if (!live) continue;
    float acc[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n] = 0.f;
    const float* Am = Ag + (long long)m * p.sAm;
    for (int kb = 0; kb < p.Kb; ++kb) {
      if (!kblock_live(p, g, i, 0, kb)) continue;
      const int k_hi = min(kb * p.bk + p.bk, p.K);
      for (int k = kb * p.bk; k < k_hi; ++k) {
        const float a = Am[(long long)k * p.sAk];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (n < p.N) acc[n] = fmaf(a, Bs[k * p.N + n][lane], acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (n < p.N) Os[lane][r * p.N + n] = acc[n];
  }
  __syncthreads();

  // Group g's output rows [m0, m0 + rows) are one contiguous span of
  // rows * N floats: a warp writes 32 consecutive floats of one span, and
  // reads mult there, along m.
  const int span = min(p.rows, p.M - m0) * p.N;
  const int spans = min(kLanes, p.G - g0);
  for (int e = threadIdx.x; e < spans * span; e += kThreads) {
    const int l = e / span;
    const int f = e - l * span;
    const int r = f / p.N;
    if (!Ls[l][r]) continue;
    const int gg = g0 + l;
    const int m = m0 + r;
    const int n = f - r * p.N;
    emit(p, ((long long)gg * p.M + m) * p.N + n, gg, m, n, Os[l][f]);
  }
}

// Group-major k: block (gc, z) covers groups [32 gc, 32 gc + 32), one
// (M x N) tile each, over split z's k blocks; warp w takes k = w, w + 8, ...
// of each k block.  kN is N rounded up to a power of two.
template <int kN>
__global__ void __launch_bounds__(kThreads)
group_k_kernel(const GemmArgs p) {
  if (!gm_runs(p)) return;
  constexpr int kM = kKMaxMN / kN;
  const int lane = threadIdx.x & (kLanes - 1);
  const int sl = threadIdx.x / kLanes;
  const int g = blockIdx.x * kLanes + lane;
  const bool live = g < p.G && gm_live(p, g, 0, 0);
  int kb_lo = 0, kb_hi = p.Kb;
  if (p.splits > 1) split_range(p, blockIdx.z, kb_lo, kb_hi);

  float acc[kM][kN];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kN; ++n) acc[m][n] = 0.f;
  if (live) {
    const float* Ag = p.A + (long long)g * p.sAg;
    const float* Bg = p.B + (long long)g * p.sBg;
    for (int kb = kb_lo; kb < kb_hi; ++kb) {
      if (!kblock_live(p, g, 0, 0, kb)) continue;
      const int k_hi = min(kb * p.bk + p.bk, p.K);
      for (int k = kb * p.bk + sl; k < k_hi; k += kSubLanes) {
        const float* Ak = Ag + (long long)k * p.sAk;
        const float* Bk = Bg + (long long)k * p.sBk;
        float b[kN];
#pragma unroll
        for (int n = 0; n < kN; ++n)
          b[n] = n < p.N ? Bk[(long long)n * p.sBn] : 0.f;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float a = m < p.M ? Ak[(long long)m * p.sAm] : 0.f;
#pragma unroll
          for (int n = 0; n < kN; ++n) acc[m][n] = fmaf(a, b[n], acc[m][n]);
        }
      }
    }
  }

  __shared__ float red[kSubLanes][kLanes][kKMaxMN + 1];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kN; ++n) red[sl][lane][m * kN + n] = acc[m][n];
  __syncthreads();
  if (sl != 0 || !live) return;
  float* ws = p.splits > 1 ? p.ws + (long long)blockIdx.z * p.G * p.M * p.N
                           : nullptr;
  for (int m = 0; m < p.M; ++m) {
    for (int n = 0; n < p.N; ++n) {
      float v = red[0][lane][m * kN + n];
#pragma unroll
      for (int s = 1; s < kSubLanes; ++s) v += red[s][lane][m * kN + n];
      const long long o = ((long long)g * p.M + m) * p.N + n;
      if (ws != nullptr) {
        ws[o] = v;
        shadow_ws_write(&ws[o]);
      } else {
        emit(p, o, g, m, n, v);
      }
    }
  }
}

// Group-major compact pre-pass: member[fi[s] * Nb + jj[s]] = 1 for the
// queue's slots s < n_live, nothing on overflow.  member arrives zeroed.
__global__ void queue_member_kernel(const int* __restrict__ q_fi,
                                    const int* __restrict__ q_jj,
                                    const int* __restrict__ n_live, int cap,
                                    int Nb, int* __restrict__ member) {
  const int nl = *n_live;
  if (nl > cap) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < nl;
       s += gridDim.x * blockDim.x)
    member[(long long)q_fi[s] * Nb + q_jj[s]] = 1;
}

// Splits [lo, hi) of the up to 4 adjacent workspace floats at offset o,
// added in split order: a float4 load each where `vec` says the unit is 4
// whole, 16-byte aligned floats, else cnt scalar loads.  Loads go out in
// batches of kReduceLoads, all of a batch before its adds.
__device__ __forceinline__ float4 ws_load(const float* w, bool vec, int cnt) {
  shadow_ws_read(w, vec ? 4 : cnt);
  if (vec) return *reinterpret_cast<const float4*>(w);
  float4 r;
  r.x = w[0];
  r.y = cnt > 1 ? w[1] : 0.f;
  r.z = cnt > 2 ? w[2] : 0.f;
  r.w = cnt > 3 ? w[3] : 0.f;
  return r;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int kLoads>
__device__ __forceinline__ float4 chunk_sum(const float* ws, long long slice,
                                            long long o, int lo, int hi,
                                            bool vec, int cnt) {
  float4 acc = ws_load(ws + lo * slice + o, vec, cnt);
  for (int s0 = lo + 1; s0 < hi; s0 += kLoads) {
    float4 r[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (s0 + k < hi) r[k] = ws_load(ws + (s0 + k) * slice + o, vec, cnt);
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (s0 + k < hi) add4(acc, r[k]);
  }
  return acc;
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The split-K reduce.  A work unit is up to 4 adjacent outputs and one
// chunk of the splits; thread (c, q) = (threadIdx.x / Q, % Q) takes chunk c
// of unit q of its block, so a warp reads consecutive units of one split.
// Chunk c holds splits [c S / C, (c + 1) S / C), summed in split order; the
// C chunk sums of a unit are added in chunk order through shared memory.
//   standard  block (t, y, z): the tile that GEMM block (t, y) wrote
//             (tile_of: queue slot or out_mask bit), units z Q ... of its
//             128 x 128 piece, 4 along n in each row;
//   group k   block x: units x Q ... of the flat (G, M, N) workspace, which
//             runs across the groups (each group one M x N tile), every
//             output written where its group's tile is live (gm_live).
// kLoads: the loads of a batch, the splits of a chunk after its first
// rounded up to a power of two (at most kReduceLoads), so that a reduce of
// few splits holds no registers for loads it never makes.
template <int kLoads>
__global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const GemmArgs p) {
  __shared__ float4 red[kThreads];
  const int Q = p.r_quads;
  const int c = threadIdx.x / Q;
  const int q = threadIdx.x - c * Q;
  const long long slice = (long long)p.G * p.M * p.N;
  int g = 0, i = 0, j = 0, m = 0, n = 0, cnt = 0;
  long long o = 0;
  unsigned live = 0;  // bit e: output e of the unit is written
  bool vec = false;
  if (p.path == kStandard) {
    if (!tile_of(p, blockIdx.x, g, i, j)) return;
    const int sub_i = blockIdx.y / p.nsub_n;
    const int sub_j = blockIdx.y - sub_i * p.nsub_n;
    const int m0 = i * p.bm + sub_i * TM;
    const int m_end = min(min(i * p.bm + p.bm, m0 + TM), p.M);
    const int n0 = j * p.bn + sub_j * TN;
    const int n_end = min(min(j * p.bn + p.bn, n0 + TN), p.N);
    const int upr = (n_end - n0 + 3) >> 2;  // units per row
    const int units = max(m_end - m0, 0) * max(upr, 0);
    const int u = blockIdx.z * Q + q;
    if ((int)blockIdx.z * Q >= units) return;
    if (u < units) {
      const int r = u / upr;
      m = m0 + r;
      n = n0 + 4 * (u - r * upr);
      cnt = min(4, n_end - n);
      o = ((long long)g * p.M + m) * p.N + n;
      live = (1u << cnt) - 1u;
      vec = p.r_vec && cnt == 4;
    }
  } else {
    if (!gm_runs(p)) return;
    const long long u = (long long)blockIdx.x * Q + q;
    o = 4 * u;
    if (o < slice) {
      cnt = (int)min(4LL, slice - o);
      const int mn = p.M * p.N;
      g = (int)(o / mn);
      const int rem = (int)(o - (long long)g * mn);
      m = rem / p.N;
      n = rem - m * p.N;
      for (int e = 0, ge = g, re = rem; e < cnt; ++e) {
        if (gm_live(p, ge, 0, 0)) live |= 1u << e;
        if (++re == mn) {
          re = 0;
          ++ge;
        }
      }
      vec = p.r_vec && cnt == 4;
    }
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const int lo = (int)((long long)c * p.splits / p.r_chunks);
    const int hi = (int)((long long)(c + 1) * p.splits / p.r_chunks);
    v = chunk_sum<kLoads>(p.ws, slice, o, lo, hi, vec, cnt);
  }
  if (p.r_chunks > 1) {
    red[threadIdx.x] = v;
    __syncthreads();
    if (c != 0) return;
    for (int k = 1; k < p.r_chunks; ++k) add4(v, red[k * Q + q]);
  }
  if (vec && live == 0xfu && p.r_vec_out) {
    // 4 whole outputs: float4 sigma-prime and store; on the standard path
    // with ec % 4 == 0 (n % 4 == 0 here) they share one bitmap cell.
    if (p.mult != nullptr) {
      const float4 mu = *reinterpret_cast<const float4*>(p.mult + o);
      v.x *= mu.x;
      v.y *= mu.y;
      v.z *= mu.z;
      v.w *= mu.w;
    }
    float* dst = p.mode == kCompactOut
                     ? p.out + ((long long)blockIdx.x * p.bm + (m - i * p.bm)) *
                                   p.bn + (n - j * p.bn)
                     : p.out + o;
    *reinterpret_cast<float4*>(dst) = v;
    for (int e = 0; e < 4; ++e) shadow_out(dst + e);
    if (p.bits == nullptr) return;
    if (p.path == kStandard && p.ec % 4 == 0) {
      const float a = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                            fmaxf(fabsf(v.z), fabsf(v.w)));
      if (a > 0.f)
        p.bits[((long long)g * p.Mc + m / p.er) * p.Nc + n / p.ec] = 1;
      if (v.x != v.x || v.y != v.y || v.z != v.z || v.w != v.w)
        g_emit_nan = 1;
      return;
    }
    for (int e = 0; e < 4; ++e) {
      emit_bit(p, g, m, n, lane4(v, e));
      if (++n == p.N) {
        n = 0;
        if (++m == p.M) {
          m = 0;
          ++g;
        }
      }
    }
    return;
  }
  for (int e = 0; e < cnt; ++e) {
    if (live & (1u << e)) {
      float x = lane4(v, e);
      if (p.mode == kCompactOut) {
        if (p.mult != nullptr) x *= p.mult[o + e];
        float* d = &p.out[((long long)blockIdx.x * p.bm + (m - i * p.bm)) *
                              p.bn + (n - j * p.bn)];
        *d = x;
        shadow_out(d);
      } else {
        emit(p, o + e, g, m, n, x);
      }
    }
    if (++n == p.N) {  // the next output: group k's units run across rows
      n = 0;
      if (++m == p.M) {
        m = 0;
        ++g;
      }
    }
  }
}

// After an emitting launch: nothing when no output was NaN (the common
// case, one flag read per block); else (or with force) bits[cell] = 0 for
// every cell whose output holds a NaN.  The whole output is read then: the
// caller zero-filled it and the launch wrote only live tiles, so a NaN in
// it is exactly a NaN the epilogue met.  The last block to finish clears
// the flag.
__global__ void __launch_bounds__(kThreads)
emit_nan_fixup_kernel(const float* __restrict__ out, int* __restrict__ bits,
                      int G, int M, int N, int er, int ec, bool force) {
  if (!force && *(volatile int*)&g_emit_nan == 0) return;
  const long long total = (long long)G * M * N;
  const int Mc = (M + er - 1) / er;
  const int Nc = (N + ec - 1) / ec;
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
       o < total; o += (long long)gridDim.x * kThreads) {
    const float v = out[o];
    if (v != v) {
      const long long gm = o / N;
      const int n = (int)(o - gm * N);
      const int g = (int)(gm / M);
      const int m = (int)(gm - (long long)g * M);
      bits[((long long)g * Mc + m / er) * Nc + n / ec] = 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&g_fixup_done, 1u) == gridDim.x - 1) {
      g_emit_nan = 0;
      g_fixup_done = 0;
      __threadfence();
    }
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The group-major compact pre-pass: member, (tiles,) int32, zero-filled and
// then marked at the queue's live tiles.
int launch_member(const int* q_fi, const int* q_jj, const int* n_live,
                  int cap, int Nb, int* member, long long tiles,
                  cudaStream_t st) {
  const cudaError_t err = cudaMemsetAsync(member, 0, tiles * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (cap <= 0) return 0;
  const int blocks = (int)min((cap + kThreads - 1LL) / kThreads, 1024LL);
  queue_member_kernel<<<blocks, kThreads, 0, st>>>(q_fi, q_jj, n_live, cap,
                                                   Nb, member);
  return (int)cudaGetLastError();
}

// The NaN fix-up of an emitting launch's out (G, M, N) and bits.
int launch_fixup(const float* out, int* bits, int G, int M, int N, int er,
                 int ec, bool force, cudaStream_t st) {
  const long long total = (long long)G * M * N;
  if (total == 0) return 0;
  const int blocks = (int)min((total + kThreads - 1) / kThreads,
                              (long long)kFixupBlocks);
  emit_nan_fixup_kernel<<<blocks, kThreads, 0, st>>>(out, bits, G, M, N, er,
                                                     ec, force);
  return (int)cudaGetLastError();
}

int fill_args(GemmArgs& p, const float* A, long long sAg, long long sAm,
              long long sAk, const float* B, long long sBg, long long sBk,
              long long sBn, float* out, int* bits, const int* out_mask,
              const int* a_mask, const int* b_mask, const float* mult,
              const int* q_fi, const int* q_jj, const int* n_live, float* ws,
              int* member, int cap, int G, int M, int K, int N, int bm,
              int bk, int bn, int er, int ec, int mode, int path,
              int splits) {
  p = GemmArgs{};
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
  p.ws = ws;
  p.member = member;
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
  p.path = path;
  p.splits = splits;
  p.a_kcontig = sAk == 1;
  p.b_ncontig = sBn == 1;
  p.rows = N > 0 ? min(kRowsMaxRows, kRowsStage / N) : 1;
  if (mode != kPredicated &&
      (q_fi == nullptr || q_jj == nullptr || n_live == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == kCompactOut &&
      (G != 1 || bits != nullptr || path != kStandard))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr) ||
      (splits > 1 && path == kGroupRows) || (splits > 1 && p.Kb < splits))
    return (int)cudaErrorInvalidValue;
  if (path != kStandard && mode == kCompact && member == nullptr)
    return (int)cudaErrorInvalidValue;
  if (path == kGroupRows &&
      (p.Nb != 1 || N > 8 || (long long)K * N > kRowsMaxKN))
    return (int)cudaErrorInvalidValue;
  if (path == kGroupK && (p.Mb != 1 || p.Nb != 1 || N > 8 ||
                          (long long)M * pow2_at_least(N) > kKMaxMN))
    return (int)cudaErrorInvalidValue;
  if (path < kStandard || path > kGroupK) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The GEMM launch.  mode 0 = predicated (every (g, i, j) tile), 1 = compact
// (the queue slots; needs q_fi, q_jj, n_live), 2 = compact_out (as
// compact, at G = 1, into the (cap, bm, bn) compacted output).  With mode
// 0 and a non-null n_live it is the compact path's overflow fallback and
// runs only when n_live > cap.  path 0 = standard, 1 = group rows, 2 =
// group k; group-major compact launches read a (G, Mb, Nb) int32 member
// bitmap, (G, Mb, Nb) int32, that the launch zero-fills and marks first
// (queue_member_kernel).  With splits > 1 the launch writes raw partials
// into ws, (splits, G, M, N) float32, and masked_gemm_reduce_launch with
// the same arguments and the reduce plan finishes the product.  er/ec are
// ignored when bits is null.  An emitting launch that is not split ends
// with the NaN fix-up (emit_nan_fixup_kernel).  Returns the cudaError_t of
// the launches.
extern "C" int masked_gemm_launch(
    const float* A, long long sAg, long long sAm, long long sAk,
    const float* B, long long sBg, long long sBk, long long sBn, float* out,
    int* bits, const int* out_mask, const int* a_mask, const int* b_mask,
    const float* mult, const int* q_fi, const int* q_jj, const int* n_live,
    float* ws, int* member, int cap, int G, int M, int K, int N, int bm,
    int bk, int bn, int er, int ec, int mode, int path, int splits,
    void* stream) {
  GemmArgs p;
  const int bad = fill_args(p, A, sAg, sAm, sAk, B, sBg, sBk, sBn, out, bits,
                            out_mask, a_mask, b_mask, mult, q_fi, q_jj,
                            n_live, ws, member, cap, G, M, K, N, bm, bk, bn,
                            er, ec, mode, path, splits);
  if (bad) return bad;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M == 0 || N == 0 || G == 0 || (mode != kPredicated && cap == 0))
    return 0;
  if (path != kStandard) {
    const long long gchunks = (G + kLanes - 1) / kLanes;
    if (mode == kCompact) {
      const int err = launch_member(q_fi, q_jj, n_live, cap, p.Nb, member,
                                    (long long)G * p.Mb * p.Nb, st);
      if (err != 0) return err;
    }
    if (path == kGroupRows) {
      const long long blocks = gchunks * ((M + p.rows - 1) / p.rows);
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
      group_rows_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(p);
    } else {
      const dim3 grid((unsigned)gchunks, 1, (unsigned)splits);
      switch (pow2_at_least(N)) {
        case 1: group_k_kernel<1><<<grid, kThreads, 0, st>>>(p); break;
        case 2: group_k_kernel<2><<<grid, kThreads, 0, st>>>(p); break;
        case 4: group_k_kernel<4><<<grid, kThreads, 0, st>>>(p); break;
        default: group_k_kernel<8><<<grid, kThreads, 0, st>>>(p); break;
      }
    }
  } else {
    const long long nsub = (long long)((bm + TM - 1) / TM) * p.nsub_n;
    const long long tiles =
        mode == kPredicated ? (long long)G * p.Mb * p.Nb : (long long)cap;
    if (tiles > 0x7fffffffLL || nsub > 65535)
      return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)tiles, (unsigned)nsub, (unsigned)splits);
    if (splits > 1) {
      masked_gemm_kernel<false, true><<<grid, kThreads, 0, st>>>(p);
    } else if (mode == kCompactOut) {
      masked_gemm_kernel<true, false><<<grid, kThreads, 0, st>>>(p);
    } else {
      masked_gemm_kernel<false, false><<<grid, kThreads, 0, st>>>(p);
    }
  }
  const int err = (int)cudaGetLastError();
  // A split launch emits nothing: its reduce does, and the fix-up follows it.
  if (err != 0 || bits == nullptr || splits > 1) return err;
  return launch_fixup(out, bits, G, M, N, p.er, p.ec, false, st);
}

// The split-K reduce, launched after masked_gemm_launch with its arguments
// (splits > 1) and the reduce plan: the partials in ws summed in the plan's
// order (r_chunks chunks of the splits, each in split order, then the
// chunks in chunk order; r_quads units of 4 outputs a block, r_chunks *
// r_quads = 256 threads), the epilogue, the live tiles written.  The grid
// is (tiles or slots, 128 x 128 pieces, r_grid) on the standard path and
// (r_grid) on group k.  An emitting reduce ends with the NaN fix-up.
extern "C" int masked_gemm_reduce_launch(
    const float* A, long long sAg, long long sAm, long long sAk,
    const float* B, long long sBg, long long sBk, long long sBn, float* out,
    int* bits, const int* out_mask, const int* a_mask, const int* b_mask,
    const float* mult, const int* q_fi, const int* q_jj, const int* n_live,
    float* ws, int* member, int cap, int G, int M, int K, int N, int bm,
    int bk, int bn, int er, int ec, int mode, int path, int splits,
    int r_chunks, int r_quads, int r_grid, void* stream) {
  GemmArgs p;
  const int bad = fill_args(p, A, sAg, sAm, sAk, B, sBg, sBk, sBn, out, bits,
                            out_mask, a_mask, b_mask, mult, q_fi, q_jj,
                            n_live, ws, member, cap, G, M, K, N, bm, bk, bn,
                            er, ec, mode, path, splits);
  if (bad) return bad;
  if (splits < 2 || r_chunks < 1 || r_chunks > splits || r_quads < 1 ||
      r_chunks * r_quads != kThreads || r_grid < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0 || G == 0 || (mode != kPredicated && cap == 0))
    return 0;
  p.r_chunks = r_chunks;
  p.r_quads = r_quads;
  p.r_grid = r_grid;
  // float4 workspace loads: a unit starts at a multiple of 4 of every
  // split's slice, which needs a 16-byte aligned ws and a slice of whole
  // float4s: on group k, G * M * N % 4 == 0 (units run over the flat
  // workspace); on the standard path N % 4 == 0 and bn % 4 == 0 (units
  // start at a multiple of 4 of their row).
  p.r_vec = ((unsigned long long)ws & 15) == 0 &&
            (path == kGroupK ? (long long)G * M * N % 4 == 0
                             : N % 4 == 0 && bn % 4 == 0);
  p.r_vec_out = ((unsigned long long)out & 15) == 0 &&
                ((unsigned long long)mult & 15) == 0;
  dim3 grid((unsigned)r_grid);
  if (path == kStandard) {
    const long long nsub = (long long)((bm + TM - 1) / TM) * p.nsub_n;
    const long long tiles =
        mode != kPredicated ? (long long)cap : (long long)G * p.Mb * p.Nb;
    if (tiles > 0x7fffffffLL || nsub > 65535 || r_grid > 65535)
      return (int)cudaErrorInvalidConfiguration;
    grid = dim3((unsigned)tiles, (unsigned)nsub, (unsigned)r_grid);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pow2_at_least((splits + r_chunks - 1) / r_chunks - 1)) {
    case 1: splitk_reduce_kernel<1><<<grid, kThreads, 0, st>>>(p); break;
    case 2: splitk_reduce_kernel<2><<<grid, kThreads, 0, st>>>(p); break;
    case 4: splitk_reduce_kernel<4><<<grid, kThreads, 0, st>>>(p); break;
    default:
      splitk_reduce_kernel<kReduceLoads><<<grid, kThreads, 0, st>>>(p);
      break;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0 || bits == nullptr) return err;
  return launch_fixup(out, bits, G, M, N, p.er, p.ec, false, st);
}

// The group-major compact pre-pass alone, as masked_gemm_launch runs it:
// member, (tiles,) int32, is zero-filled, then gets 1 at every tile of
// queue slots s < n_live (fused row q_fi[s], column q_jj[s]); nothing when
// n_live > cap (overflow).
extern "C" int queue_member_launch(const int* q_fi, const int* q_jj,
                                   const int* n_live, int cap, int Nb,
                                   int* member, long long tiles,
                                   void* stream) {
  return launch_member(q_fi, q_jj, n_live, cap, Nb, member, tiles,
                       (cudaStream_t)stream);
}

// The NaN fix-up alone, whatever the device flag says: bits[cell] = 0 for
// every cell of out (G, M, N) whose output holds a NaN (bits is (G,
// ceil(M/er), ceil(N/ec))).  The launchers run it after every emitting
// launch, gated on the flag.
extern "C" int emit_nan_fixup_launch(const float* out, int* bits, int G,
                                     int M, int N, int er, int ec,
                                     void* stream) {
  return launch_fixup(out, bits, G, M, N, er, ec, true,
                      (cudaStream_t)stream);
}

#ifdef REPRO_SHADOW
// Shadow build only: arm (or, with null counters, disarm) the write
// counters for the launches that follow on this device.  out_writes counts
// (out_n,) int32 and ws_writes (ws_n,) int32, zero-filled by the caller;
// unwritten is one int32.  Returns the cudaError_t of the copy.
extern "C" int shadow_arm(const float* out, long long out_n, int* out_writes,
                          const float* ws, long long ws_n, int* ws_writes,
                          int* unwritten, void* stream) {
  const Shadow s{out, out_n, out_writes, ws, ws_n, ws_writes, unwritten};
  return (int)cudaMemcpyToSymbolAsync(g_shadow, &s, sizeof(s), 0,
                                      cudaMemcpyHostToDevice,
                                      (cudaStream_t)stream);
}
#endif
