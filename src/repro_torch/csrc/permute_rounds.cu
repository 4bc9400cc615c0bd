// Every sub-round of a BBS broadcast on n virtual devices in one persistent
// launch: the cycle loop of csrc/permute_step.cu's round step, with a
// grid-wide barrier between dependency phases of the sub-rounds' moves in
// place of a launch each.
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
// Bound: bytes. The plans' sub-rounds are small: the mesh2d 16 x 16, 16 MiB
// broadcast moves about 91 rows of 21,744 B a sub-round (read one, write
// one), 3.97 MB, 1.19 us at 3.35 TB/s, while a grid barrier costs about
// 1.3 us (PERF.md). But most of a sub-round's moves do not depend on the
// sub-round before it. The design:
//
// 1. One launch per broadcast. A cooperative launch (every block resident)
//    of one block of 1,024 threads on every SM walks steps [s0, s1) and
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
// 3. A barrier a dependency phase, not a sub-round. A second host pass
//    (permute_rounds_phases below, once per plan) puts each move, taken in
//    sub-round order, in the first phase after the last that wrote its
//    source row (read after write), wrote its destination row (write after
//    write) or read that row's value (write after read), and that holds
//    fewer than a cap of moves. It orders the pairs by phase, stably, and
//    the offsets of each phase's pairs take the place of the sub-rounds'.
//    No phase reads a row that one of its moves writes or writes a row
//    twice, so a phase is a step like a sub-round, and every row goes
//    through the same values in the same order: the bytes are those of the
//    sub-rounds one after another. The cap (round_step.phase_cap: the rows
//    of 16 MiB, at least 320) keeps a phase's writes within reach of the
//    L2 for the next phase, which reads most of them, as a sub-round read
//    what the one before it wrote. The cells' plans of 345-14,288
//    sub-rounds run in 63-2,040 phases. A launch over a plan's whole range
//    runs its phases; any other range runs its sub-rounds, each a step; a
//    plan whose every sub-round feeds the next has a phase a sub-round.
// 4. A copy loop for steps of megabytes to gigabytes. A step's rows are cut
//    into pieces of 32 x kLoads chunks of 16 bytes, and each warp takes
//    pieces grid-stride: the warp loads the piece's (dst, src) pair once,
//    each lane issues its kLoads loads, 32 chunks apart so that a warp's
//    loads cover 512 contiguous bytes each, then its stores. The next
//    piece's pair is loaded before the current piece's rows, and the next
//    step's first pair before the barrier (the tables are read-only), so
//    only a row's own load and store follow the barrier.
//
// Coherence: buf changes inside the launch, so its loads bypass the
// non-coherent and L1 paths (ld.global.cg, no const __restrict__, no
// __ldg); the block's stores are ordered before its arrival by
// __syncthreads and the arrival's release, and the acquire on the way out
// orders the next step's loads after every block's stores. Byte offsets
// are 64-bit: the main path's buffer is 4,297,310,208 B. Launches on the
// caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <vector>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;          // 16-byte loads a thread keeps in flight
constexpr int kPiece = 32 * kLoads;  // chunks of a warp's piece of a row

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

// moves: (dst, src) byte offsets of rows, step s's at [offs[s],
// offs[s + 1]) (a step is a phase or a sub-round); chunks: 16-byte chunks
// of a row.
__global__ void __launch_bounds__(kThreads)
permute_rounds_kernel(uint8_t* buf, const longlong2* __restrict__ moves,
                      const long long* __restrict__ offs, int s0, int s1,
                      int chunks, unsigned* bar) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int pieces = (chunks + kPiece - 1) / kPiece;   // pieces of a row
  // a step's first pair and piece count, and the pair of this warp's
  // first piece of it, loaded ahead of its barrier
  long long first = 0;
  int total = 0;
  longlong2 next = make_longlong2(0, -1);
  auto fetch = [&](int s) {
    first = offs[s];
    total = (int)(offs[s + 1] - first) * pieces;
    if (warp < total) next = moves[first + warp / pieces];
  };
  fetch(s0);
  for (int s = s0; s < s1; ++s) {
    if (s > s0) grid_sync(bar);
    const long long f = first;
    const int n = total;
    for (int t = warp; t < n; t += warps) {
      const int row = t / pieces;
      const int c0 = (t - row * pieces) * kPiece + lane;
      const longlong2 mv = next;
      if (t + warps < n) next = moves[f + (t + warps) / pieces];
      uint4 val[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = c0 + u * 32;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (mv.y >= 0 && c < chunks)
          val[u] = __ldcg(reinterpret_cast<const uint4*>(buf + mv.y) + c);
      }
      uint4* dst = reinterpret_cast<uint4*>(buf + mv.x);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = c0 + u * 32;
        if (c < chunks) __stcg(dst + c, val[u]);
      }
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

// buf: uint8, 16-byte aligned, holding every row the moves name; a row is
// 16 x chunks bytes; moves: int64 [M, 2] (dst, src), the rows' byte offsets
// into buf, multiples of 16, rows that do not overlap, src -1 for a zero
// write; offs: int64 [S + 1], step s's moves at [offs[s], offs[s + 1]), no
// step reading a row that one of its moves writes or writing a row twice;
// both on the same device. Runs steps [s0, s1) (s0 < s1) in one
// cooperative launch. Every step's count x chunks fits 2**30. bar: one
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

// The dependency phases of a plan's moves (header, 3), on the host; its
// plain version is round_step.phase_table_ref. pairs: int64 [m, 2] (dst,
// src) row indexes in [0, rows) (src -1: a zero write), sub-round s's at
// [sub_offs[s], sub_offs[s + 1]), sub_offs[subrounds] = m, rows < 2**31.
// A move goes to the first phase after those its rows ask that holds fewer
// than cap moves (cap <= 0: no cap). Writes the moves' indexes in phase
// order to order (int64 [m]; a phase's in sub-round order) and phase p's
// range of them, [offs[p], offs[p + 1]), to offs (int64, room for m + 1),
// and returns the number of phases; or -1 when a sub-round reads a row
// that it writes or writes a row twice, -2 when a row lies outside
// [0, rows).
extern "C" long long permute_rounds_phases(
    const long long* pairs, long long m, const long long* sub_offs,
    long long subrounds, long long rows, long long cap, long long* order,
    long long* offs) {
  // per row: the last phase that wrote it and the highest that read it
  // (-1: none), and the last sub-round that wrote it and that read it;
  // kept from call to call, whose fresh pages cost more than the walk
  struct Row { int wrote, read, wrote_in, read_in; };
  thread_local std::vector<Row> at_row;
  thread_local std::vector<int> phase;  // each move's
  at_row.assign(rows, Row{-1, -1, -1, -1});
  phase.resize(m);
  std::vector<long long> count;       // moves a phase
  std::vector<int> open;              // a phase at or after p with room
  constexpr long long kAhead = 32;    // moves whose rows are prefetched:
                                      // halves the walk on a server host
  auto first_open = [&](int p) {
    while (p < (int)open.size() && open[p] != p) {
      const int q = open[p];
      if (q < (int)open.size()) open[p] = open[q];
      p = q;
    }
    return p;
  };
  for (long long s = 0; s < subrounds; ++s) {
    const int sub = (int)s;
    for (long long i = sub_offs[s]; i < sub_offs[s + 1]; ++i) {
      if (i + kAhead < m)
        for (int k = 0; k < 2; ++k) {
          const long long x = pairs[2 * (i + kAhead) + k];
          if (x >= 0 && x < rows) __builtin_prefetch(&at_row[x], 1);
        }
      const long long d = pairs[2 * i], r = pairs[2 * i + 1];
      if (d < 0 || d >= rows || r < -1 || r >= rows) return -2;
      Row& w = at_row[d];
      if (w.wrote_in == sub || w.read_in == sub) return -1;
      int p = std::max(w.wrote, w.read);
      if (r >= 0) {
        const Row& x = at_row[r];
        if (x.wrote_in == sub) return -1;
        p = std::max(p, x.wrote);
      }
      p = first_open(p + 1);
      if (p == (int)count.size()) {
        count.push_back(0);
        open.push_back(p);
      }
      if (++count[p] == cap) open[p] = p + 1;
      phase[i] = p;
      w.wrote = p;
      w.wrote_in = sub;
      if (r >= 0) {
        Row& x = at_row[r];
        x.read = std::max(x.read, p);
        x.read_in = sub;
      }
    }
  }
  // a counting sort of the moves by phase, stable
  const long long phases = (long long)count.size();
  offs[0] = 0;
  for (long long p = 0; p < phases; ++p) offs[p + 1] = offs[p] + count[p];
  for (long long p = 0; p < phases; ++p) count[p] = offs[p];
  for (long long i = 0; i < m; ++i) order[count[phase[i]]++] = i;
  return phases;
}
