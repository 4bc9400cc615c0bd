// The scan design of the simulator's event core, kept as the
// yardstick of csrc/event_core.cu, which the main path launches since:
// per-task completion times and admission sequence numbers of a lowered
// task list, for L lanes (message sizes) that share one structure, in one
// launch, each step a scan of all n tasks.
//
// Replaces src/repro/core/kernelsim.py:121 (_core): an XLA lax.while_loop,
// jitted and vmapped over lanes, not a Pallas kernel. It computes what _core
// computes, not a transcription of XLA's loop. Per lane, from status 0
// (unstarted) for every task, status 2 in the sentinel slot n (so padded
// dependency rows read as done), zero occupancy and now = 0, each step is
//
//   admission, if any task is unstarted, has every dependency at status 2
//   and every resource of its row below capacity: the task i of least rank
//   gets status 1, busy += 1 on every entry of its row (the dummy pad and
//   repeats included), fin[i] = now + durs[i], seq[i] = ctr++;
//
//   otherwise completion: the task j of least (fin, seq, index) over all n
//   tasks (fin is inf for a task that is not running) gives now = fin[j],
//   comp[j] = fin[j], fin[j] = inf, status 2, busy -= 1 over its row;
//
// until n tasks have completed, so a lane ends in at most 2n steps. The
// (fin, seq, index) order is exactly the reference's
// argmin(where(fin == min(fin), seqs, BIG)), inf included: argmin takes the
// first index among equal keys.
//
// Exactness: the only arithmetic is the float64 add now + durs[i], written
// as __dadd_rn; the build passes -fmad=false and no fast-math flag
// (repro_torch/nvcc.py). Every comparison is exact. The block reductions
// decide ties by the keys above, never by arrival order, and the only
// atomics are integer adds to the occupancy counts, whose result does not
// depend on their order. So completion times are bit-identical to the
// numpy engine's and the reference's.
//
// Design and bound: one block per lane (grid = L), up to 1,024 threads; a
// lane's 2n steps run inside the block with no host round trip, and lanes
// run side by side on the SMs. A step is a block-wide scan of the n tasks
// (a thread skips a task that is not unstarted, then stops at its first
// unmet dependency or full resource: at most D + K int32 reads a task) and
// one or two block min-reductions; one thread applies the step's effect,
// its row's occupancy updates spread over the block. The 2n steps are
// dependent, so the kernel is bound by the latency of a step, not by bytes
// or operations: the bytes a lane must move (the structure and its durs
// read once, comp and seqs written once) take microseconds at 3.35 TB/s.
// csrc/event_core.cu keeps the admissible set incrementally instead, so a
// step touches only the tasks its effect changed.
//
// Lane state (status int8 [n + 1], busy int32 [W], fin float64 [n]) lives
// in a workspace the wrapper allocates with torch.empty, and the outputs
// (comp float64 [n], seqs int32 [n], which is also the seq state) are
// written in place; the kernel initialises all of them. It is read and
// written with plain loads and stores, ordered by __syncthreads (the lane's
// state is its block's alone); the shared structure (rank, res, caps, deps)
// and durs go through the read-only path. Launches on the caller's stream
// and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBigSeq = INT_MAX;       // _BIG_SEQ: seq of a task never admitted
constexpr unsigned kFull = 0xffffffffu;

struct Key {                           // a completion candidate
  double fin;
  int seq;
  int idx;
};

__device__ __forceinline__ bool less(const Key& a, const Key& b) {
  if (a.fin != b.fin) return a.fin < b.fin;
  if (a.seq != b.seq) return a.seq < b.seq;
  return a.idx < b.idx;
}

__device__ __forceinline__ Key shfl_xor(const Key& k, int off) {
  return Key{__shfl_xor_sync(kFull, k.fin, off),
             __shfl_xor_sync(kFull, k.seq, off),
             __shfl_xor_sync(kFull, k.idx, off)};
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Block-wide minimum, handed to every thread. blockDim.x is a multiple of
// 32 (every warp full). sh holds 33 values: one per warp and the result.
__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* sh) {
  v = warp_min(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_min(lane < (int)(blockDim.x >> 5) ? sh[lane] : ~0ull);
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  return sh[32];
}

__device__ Key block_min(Key k, Key* sh) {
  for (int off = 16; off; off >>= 1) {
    const Key o = shfl_xor(k, off);
    if (less(o, k)) k = o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = lane < (int)(blockDim.x >> 5)
            ? sh[lane] : Key{__longlong_as_double(0x7ff0000000000000ll),
                             kBigSeq, INT_MAX};
    for (int off = 16; off; off >>= 1) {
      const Key o = shfl_xor(k, off);
      if (less(o, k)) k = o;
    }
    if (lane == 0) sh[32] = k;
  }
  __syncthreads();
  return sh[32];
}

// rank [n], res [n, K], caps [W], deps [n, D], durs [L, n] -> comp [L, n],
// seqs [L, n]; status [L, n + 1], busy [L, W], fin [L, n] are workspace.
__global__ void __launch_bounds__(kMaxThreads)
event_core_scan_kernel(const int* __restrict__ rank,
                       const int* __restrict__ res,
                       const int* __restrict__ caps,
                       const int* __restrict__ deps,
                       const double* __restrict__ durs, int n, int K, int D,
                       int W, double* comp, int* seq, int8_t* status,
                       int* busy, double* fin) {
  __shared__ unsigned long long sh_adm[33];
  __shared__ Key sh_comp[33];
  __shared__ double s_now;
  __shared__ int s_ctr, s_ncomp;

  const long long lane = blockIdx.x;
  durs += lane * n;
  comp += lane * n;
  seq += lane * n;
  fin += lane * n;
  status += lane * (n + 1);
  busy += lane * W;
  const int tid = threadIdx.x, nth = blockDim.x;
  const double inf = __longlong_as_double(0x7ff0000000000000ll);

  for (int t = tid; t < n; t += nth) {
    status[t] = 0;
    fin[t] = inf;
    seq[t] = kBigSeq;
    comp[t] = 0.0;
  }
  for (int w = tid; w < W; w += nth) busy[w] = 0;
  if (tid == 0) {
    status[n] = 2;
    s_now = 0.0;
    s_ctr = 0;
    s_ncomp = 0;
  }
  __syncthreads();

  while (s_ncomp < n) {
    // admission: the least (rank, index) over the admissible tasks
    unsigned long long best = ~0ull;
    for (int t = tid; t < n; t += nth) {
      if (status[t] != 0) continue;
      const int* dt = deps + (long long)t * D;
      bool ok = true;
      for (int d = 0; d < D && ok; ++d) ok = status[__ldg(dt + d)] == 2;
      const int* rt = res + (long long)t * K;
      for (int k = 0; k < K && ok; ++k) {
        const int r = __ldg(rt + k);
        ok = busy[r] < __ldg(caps + r);
      }
      if (ok) {
        const unsigned long long key =
            ((unsigned long long)(unsigned)__ldg(rank + t) << 32) |
            (unsigned)t;
        best = key < best ? key : best;
      }
    }
    best = block_min(best, sh_adm);
    if (best != ~0ull) {
      const int i = (int)(best & 0xffffffffu);
      if (tid == 0) {
        status[i] = 1;
        fin[i] = __dadd_rn(s_now, __ldg(durs + i));
        seq[i] = s_ctr;
        s_ctr += 1;
      }
      for (int k = tid; k < K; k += nth)
        atomicAdd(busy + __ldg(res + (long long)i * K + k), 1);
      __syncthreads();
      continue;
    }
    // completion: the least (fin, seq, index) over all tasks
    Key kb{inf, kBigSeq, INT_MAX};
    for (int t = tid; t < n; t += nth) {
      const Key c{fin[t], seq[t], t};
      if (less(c, kb)) kb = c;
    }
    kb = block_min(kb, sh_comp);
    const int j = kb.idx;
    if (tid == 0) {
      s_now = kb.fin;
      comp[j] = kb.fin;
      fin[j] = inf;
      status[j] = 2;
      s_ncomp += 1;
    }
    for (int k = tid; k < K; k += nth)
      atomicSub(busy + __ldg(res + (long long)j * K + k), 1);
    __syncthreads();
  }
}

}  // namespace

extern "C" const int event_core_scan_max_threads = kMaxThreads;

// Threads a block of event_core_scan takes for n tasks: n rounded up to a
// warp, at least one warp and at most event_core_scan_max_threads.
extern "C" int event_core_scan_threads(int n) {
  const int t = (std::max(n, 1) + 31) / 32 * 32;
  return std::min(t, kMaxThreads);
}

// rank int32 [n] (a permutation of 0..n-1), res int32 [n, K] (ids in
// [0, W)), caps int32 [W], deps int32 [n, D] (task ids in [0, n], n the
// always-done slot), durs float64 [L, n]; comp float64 [L, n] and seqs
// int32 [L, n] are written; status int8 [L, n + 1], busy int32 [L, W] and
// fin float64 [L, n] are workspace. All contiguous on one device, n, K, D,
// W, L >= 1. One block of event_core_scan_threads(n) threads per lane.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int event_core_scan(const void* rank, const void* res,
                               const void* caps, const void* deps,
                               const void* durs, int n, int K, int D, int W,
                               int L, void* comp, void* seqs, void* status,
                               void* busy, void* fin, void* stream) {
  event_core_scan_kernel<<<dim3((unsigned)L),
                           dim3(event_core_scan_threads(n)), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rank), static_cast<const int*>(res),
      static_cast<const int*>(caps), static_cast<const int*>(deps),
      static_cast<const double*>(durs), n, K, D, W,
      static_cast<double*>(comp), static_cast<int*>(seqs),
      static_cast<int8_t*>(status), static_cast<int*>(busy),
      static_cast<double*>(fin));
  return (int)cudaGetLastError();
}
