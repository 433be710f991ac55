// Work-queue construction by stream compaction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/queue_builder.py:
// _queue_builder_kernel (launched by build_queue_kernel): the row-major
// stream compaction of a (R, C) tile bitmap into the coordinates
// (t / C, t % C) of its set bits, in the order of
// repro/core/workredist.py:static_queue_order, plus the true set-bit count
// n_live (which may exceed the capacity); live tiles past the capacity are
// dropped and the dead slots hold (0, 0), valid coordinates for the
// consumer.
//
// Bound on the H100: launch latency, then one pass over the bitmap's bytes
// (the step's bitmaps hold 3,136 to 50,176 tiles, 12 to 200 KB: 4 to 60 ns
// at 3.35 TB/s).  The TPU walked the bitmap as a sequential grid with a
// running count in SMEM; one block looping over chunks would leave all but
// one SM idle (49 serial chunks at 50,176 tiles).  Here the bitmap is cut
// into blocks of 4,096 tiles, 16 a thread: a warp takes 512 consecutive
// tiles, read as four coalesced int4 loads a lane where the pointer is
// 16-byte aligned and staged in shared memory, then walked in 16 rounds
// in which lane l takes tile 32 r + l, so that the slots a round writes
// are consecutive (coalesced stores).  A warp ranks a round's tiles with
// a ballot and popc, the block scans its 8 warp counts in shared memory,
// and finds the live tiles before it by a decoupled look-back: it
// publishes its aggregate, then its inclusive prefix, in a status word, and
// its first warp reads the words of the 32 blocks before it at a time
// until one holds a prefix.  Blocks take their index from a
// ticket counter, so every block a block waits on is running.  A bitmap of
// at most 4,096 tiles (all of VGG16's) takes one block and no look-back.
// Nothing is zero-filled: the dead tile of dead rank d writes (0, 0) to
// slot T - 1 - d when it is below the capacity, and together those cover
// exactly the slots [n_live, min(cap, T)); the caller zero-fills only
// [T, cap) when cap > T.  The status words, ticket and done counter need
// no memset per call either: the last block to finish resets them for the
// next launch in stream order (launches must share one stream, as the
// port's do).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTilesPerWarp = 32 * kPerThread;         // 512
constexpr int kTilesPerBlock = kThreads * kPerThread;  // 4,096
constexpr int kMaxBlocks = 65536;                      // 2^28 tiles
constexpr unsigned kFull = 0xffffffffu;

// A block's status word: the state in bits 62-63, the count in bits 0-31.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kState = 3ull << 62;

__device__ unsigned long long g_status[kMaxBlocks];
__device__ unsigned g_ticket = 0;
__device__ unsigned g_done = 0;

__device__ __forceinline__ void publish(int bid, unsigned long long state,
                                        int count) {
  *(volatile unsigned long long*)&g_status[bid] = state | (unsigned)count;
}

// Warp-wide: the live tiles in blocks [0, bid), from their status words.
__device__ int look_back(int bid, int lane) {
  int base = 0;
  for (int end = bid - 1;; end -= 32) {
    const int idx = end - lane;
    unsigned long long w = kPrefix;  // before block 0: a prefix of 0
    if (idx >= 0) {
      do {
        w = *(volatile unsigned long long*)&g_status[idx];
      } while ((w & kState) == 0);
    }
    const unsigned prefixes = __ballot_sync(kFull, (w & kState) == kPrefix);
    // The nearest block with a prefix ends the walk; the aggregates of the
    // blocks between it and bid are added to it.
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    base += (int)__reduce_add_sync(
        kFull, lane <= stop ? (unsigned)(w & 0xffffffffu) : 0u);
    if (prefixes) return base;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
queue_builder_kernel(const int* __restrict__ bitmap, int T, int C, int cap,
                     int* __restrict__ ii, int* __restrict__ jj,
                     int* __restrict__ n_live) {
  __shared__ unsigned char flags[kWarps][kTilesPerWarp];
  __shared__ int warp_excl[kWarps];
  __shared__ int s_bid, s_base;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool single = gridDim.x == 1;
  if (tid == 0) s_bid = single ? 0 : (int)atomicAdd(&g_ticket, 1u);
  __syncthreads();
  const int bid = s_bid;
  // Warp w takes the 512 tiles from w0; round r, tiles w0 + 32 r + lane.
  const int w0 = bid * kTilesPerBlock + warp * kTilesPerWarp;

  unsigned char* f = flags[warp];
  if (kVec && w0 + kTilesPerWarp <= T) {
    // Four coalesced int4 loads a lane, staged so rounds read lane-major.
    const int4* v = reinterpret_cast<const int4*>(bitmap + w0);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      const int4 x = __ldg(v + q * 32 + lane);
      unsigned char* d = f + 4 * (q * 32 + lane);
      d[0] = x.x != 0;
      d[1] = x.y != 0;
      d[2] = x.z != 0;
      d[3] = x.w != 0;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int t = w0 + 32 * r + lane;
      f[32 * r + lane] = t < T && bitmap[t] != 0;
    }
  }
  __syncwarp();
  unsigned ballot[kPerThread];
  int count = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    ballot[r] = __ballot_sync(kFull, f[32 * r + lane]);
    count += __popc(ballot[r]);
  }
  if (lane == 0) warp_excl[warp] = count;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_excl[lane] : 0;
    int wincl = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int u = __shfl_up_sync(kFull, wincl, o);
      if (lane >= o) wincl += u;
    }
    const int total = __shfl_sync(kFull, wincl, kWarps - 1);
    if (lane < kWarps) warp_excl[lane] = wincl - w;
    int base = 0;
    if (!single) {
      if (lane == 0) publish(bid, bid == 0 ? kPrefix : kAggregate, total);
      if (bid > 0) {
        base = look_back(bid, lane);
        if (lane == 0) publish(bid, kPrefix, base + total);
      }
    }
    if (lane == 0) {
      s_base = base;
      if (bid == (int)gridDim.x - 1) *n_live = base + total;
    }
  }
  __syncthreads();

  // A live tile's slot is the live count before it; a dead tile of dead
  // rank d writes (0, 0) to slot T - 1 - d.  Within a round the live lanes
  // write consecutive slots, the dead lanes consecutive slots downwards.
  const unsigned below = (1u << lane) - 1u;
  int before = s_base + warp_excl[warp];  // live tiles before the round
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int t = w0 + 32 * r + lane;
    const int rank = before + __popc(ballot[r] & below);
    if (t < T) {
      if (ballot[r] >> lane & 1u) {
        if (rank < cap) {
          const int row = C == 1 ? t : t / C;
          ii[rank] = row;
          jj[rank] = t - row * C;
        }
      } else {
        const int slot = T - 1 - (t - rank);
        if (slot < cap) {
          ii[slot] = 0;
          jj[slot] = 0;
        }
      }
    }
    before += __popc(ballot[r]);
  }
  if (single) return;

  // Every block is past its look-back once it counts itself done: the last
  // one clears the status words, the ticket and the count for the next
  // launch.
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&g_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  for (int b = tid; b < (int)gridDim.x; b += kThreads) g_status[b] = 0;
  if (tid == 0) {
    g_ticket = 0;
    g_done = 0;
  }
  __threadfence();
}

}  // namespace

// bitmap: (R, C) int32 row-major, T = R * C <= 2^28.  ii, jj: (cap,) int32;
// slots [T, cap) are the caller's to zero-fill when cap > T, every other
// slot is written here.  n_live: (1,) int32.  Returns the cudaError_t of
// the launch.
extern "C" int queue_builder_launch(const int* bitmap, int T, int C, int cap,
                                    int* ii, int* jj, int* n_live,
                                    void* stream) {
  if (T < 0 || C < 1 || cap < 0) return (int)cudaErrorInvalidValue;
  const long long blocks =
      T == 0 ? 1 : ((long long)T + kTilesPerBlock - 1) / kTilesPerBlock;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (((unsigned long long)bitmap & 15) == 0) {
    queue_builder_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        bitmap, T, C, cap, ii, jj, n_live);
  } else {
    queue_builder_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        bitmap, T, C, cap, ii, jj, n_live);
  }
  return (int)cudaGetLastError();
}
