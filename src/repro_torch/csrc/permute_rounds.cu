// Every sub-round of a BBS broadcast on n virtual devices in one persistent
// launch: the cycle loop of csrc/permute_step.cu's round step, with a
// grid-wide barrier between sub-rounds in place of a launch each.
//
// Replaces the TPU kernel src/repro/device/pallas_step.py:46
// (_scatter_gather_kernel) for the whole cycle loop, as the reference's
// lax.scan ran it: per sub-round each device wrote the received row at r_idx
// if r_ok and read the row at s_idx, zeroed unless s_ok, and a
// jax.lax.ppermute carried the read row to the next device. Here the n
// devices' packet buffers are one [n, rows, row_bytes] byte tensor, and each
// sub-round is, for every receiver v of its [src, s_ix, s_ok, r_ix, r_ok]
// table,
//
//   val = (src[v] >= 0 && s_ok[src[v]]) ? buf[src[v], s_ix[src[v]]] : 0
//   if (r_ok[v]) buf[v, r_ix[v]] = val
//
// Every read sees the buffer as it was before its sub-round; sub-round s + 1
// sees every write of sub-round s. In place without a race inside a
// sub-round because no device sends and receives one row
// (repro_torch/device/schedule.py checks it). Raw bytes: every dtype and
// every NaN payload comes through bit-exact.
//
// Bound: bytes. A sub-round of the mesh2d 16 x 16, 16 MiB broadcast moves
// about 91 rows of 21,744 B (read one, write one): 3.97 MB, 1.19 us at
// 3.35 TB/s, under one row per SM. One launch per sub-round spent about
// 3.7 us on start-up, drain and one dependent load and store (PERF.md). The
// design:
//
// 1. One launch per broadcast. A cooperative launch (every block resident)
//    of one block of 1,024 threads on every SM walks sub-rounds [s0, s1) and
//    meets at a grid-wide barrier between them. The barrier is one word: a
//    block's first thread adds 1 to it (block 0 adds 2^31 - (blocks - 1))
//    with atom.release.gpu.add, so the top bit flips when the last block
//    arrives and the low bits are back where they were; it spins on
//    ld.acquire.gpu until the bit differs from the one its own add saw,
//    with __syncthreads on both sides. The word lives in a workspace the
//    wrapper allocates once, zeroed, and needs no reset between launches.
//    The occupancy calculator must fit a block on an SM, or the wrapper
//    raises; the grid is capped at one block an SM because a second block
//    doubles the barrier's arrivals and measured slower (PERF.md).
// 2. Only the moves that happen. A host pass (round_step.compact_moves,
//    once per plan) keeps for each sub-round the (dst_row, src_row) pairs of
//    its receivers with r_ok, as global row indexes v * rows + r_ix[v]
//    (src_row -1: a zero write), and the offsets of each sub-round's pairs.
//    The kernel reads each pair as the two rows' byte offsets into one
//    allocation (Moves.offsets, once per plan and placement): row * row_bytes
//    in the [n, rows, row_bytes] buffer, or wherever a placement puts the
//    row (the runner's in-place layout: straight into the stacked output).
//    The kernel never visits an idle receiver.
// 3. Row moves spread over the whole grid. A sub-round's count x chunks
//    16-byte chunks are split evenly over every thread of the grid,
//    neighbouring threads on neighbouring chunks of a row; a thread issues
//    all its loads before its stores. Before it waits at a barrier, a
//    thread loads the next sub-round's offsets and its first moves (the
//    tables are read-only), so only the row's own load and store follow
//    the barrier.
//
// Coherence: buf changes inside the launch, so its loads bypass the
// non-coherent and L1 paths (ld.global.cg, no const __restrict__, no
// __ldg); the block's stores are ordered before its arrival by
// __syncthreads and the arrival's release, and the acquire on the way out
// orders the next sub-round's loads after every block's stores. Byte
// offsets are 64-bit: the main path's buffer is 4,297,310,208 B. Launches on
// the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;       // chunks a thread keeps in flight

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The grid-wide barrier on the word *bar (see the header).
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old;
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(add) : "memory");
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) __nanosleep(32);
  }
  __syncthreads();
}

// moves: (dst, src) byte offsets of rows, sub-round s's at
// [offs[s], offs[s + 1]); chunks: 16-byte chunks of a row.
__global__ void __launch_bounds__(kThreads)
permute_rounds_kernel(uint8_t* buf, const longlong2* __restrict__ moves,
                      const long long* __restrict__ offs, int s0, int s1,
                      int chunks, unsigned* bar) {
  const int nthreads = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  // a sub-round's first pair and chunk count, and this thread's first
  // kUnroll pairs of it, loaded ahead of its barrier
  long long first = 0;
  int total = 0;
  longlong2 ahead[kUnroll];
  auto fetch = [&](int s) {
    first = offs[s];
    total = (int)(offs[s + 1] - first) * chunks;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = tid + u * nthreads;
      if (i < total) ahead[u] = moves[first + i / chunks];
    }
  };
  fetch(s0);
  for (int s = s0; s < s1; ++s) {
    if (s > s0) grid_sync(bar);
    const long long f = first;
    const int n = total;
    for (int base = tid; base < n; base += kUnroll * nthreads) {
      uint4 val[kUnroll];
      uint4* dst[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * nthreads;
        dst[u] = nullptr;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n) {
          const int m = i / chunks, c = i - m * chunks;
          const longlong2 mv = base == tid ? ahead[u] : moves[f + m];
          dst[u] = reinterpret_cast<uint4*>(buf + mv.x) + c;
          if (mv.y >= 0)
            val[u] = __ldcg(reinterpret_cast<const uint4*>(buf + mv.y) + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (dst[u]) __stcg(dst[u], val[u]);
    }
    if (s + 1 < s1) fetch(s + 1);
  }
}

// Blocks of the cooperative grid on the current device: one per SM once
// the occupancy calculator fits one, cached per device; negative: a CUDA
// error, 0: the kernel does not fit an SM.
int grid_blocks() {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 64 && cached[dev].load() > 0) return cached[dev].load();
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, permute_rounds_kernel, kThreads, 0)) != cudaSuccess)
    return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  const int blocks = std::min(per_sm, 1) * sms;
  if (dev < 64 && blocks > 0) cached[dev].store(blocks);
  return blocks;
}

}  // namespace

// The grid permute_rounds launches on the current device (blocks of
// permute_rounds_threads threads), or minus a CUDA error.
extern "C" int permute_rounds_blocks() { return grid_blocks(); }

extern "C" const int permute_rounds_threads = kThreads;
extern "C" const int permute_rounds_unroll = kUnroll;

// buf: uint8, 16-byte aligned, holding every row the moves name; a row is
// 16 x chunks bytes; moves: int64 [M, 2] (dst, src), the rows' byte offsets
// into buf, multiples of 16, rows that do not overlap, src -1 for a zero
// write; offs: int64 [S + 1], sub-round
// s's moves at [offs[s], offs[s + 1]); both on the same device. Runs
// sub-rounds [s0, s1) (s0 < s1) in one cooperative launch. Every count x
// chunks + permute_rounds_unroll x the grid's threads fits an int. bar: one
// uint32 word of device memory, zero when first used, used by one stream at
// a time. Returns cudaGetLastError() after the launch (0 on success):
// a refused cooperative launch is an error, never a smaller grid.
extern "C" int permute_rounds(void* buf, const void* moves, const void* offs,
                              int s0, int s1, int chunks, void* bar,
                              void* stream) {
  const int blocks = grid_blocks();
  if (blocks < 0) return -blocks;
  if (blocks == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  uint8_t* b = static_cast<uint8_t*>(buf);
  const longlong2* m = static_cast<const longlong2*>(moves);
  const long long* o = static_cast<const long long*>(offs);
  unsigned* w = static_cast<unsigned*>(bar);
  void* args[] = {&b, &m, &o, &s0, &s1, &chunks, &w};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)permute_rounds_kernel, dim3((unsigned)blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();            // clear it; the wrapper raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}
