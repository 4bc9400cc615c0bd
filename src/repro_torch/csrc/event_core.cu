// The simulator's event core: per-task completion times and admission
// sequence numbers of a lowered task list, for L lanes (message sizes)
// that share one structure, in one launch, each step touching only the
// tasks its effect changes.
//
// Replaces src/repro/core/kernelsim.py:121 (_core): an XLA lax.while_loop,
// jitted and vmapped over lanes, not a Pallas kernel. It computes exactly
// what _core (and the port's event_core_ref) computes: per lane, from every
// task unstarted, zero occupancy and now = 0, each step admits the
// unstarted task of least rank whose dependencies are all done and whose
// resources are all below capacity (fin = now + dur, seq = ctr++, the row
// added to the occupancy), or, when there is none, completes the task of
// least (fin, seq, index) (now = comp = fin, the row subtracted), until n
// completions. Rather than scanning all n tasks a step, a step finds its
// task so:
//
//   ready set: a bitmap in shared memory, a bit a rank, set for a task
//   that is unstarted, has every dependency done and is not parked, with a
//   summary bit a word. A task joins it when its count of unmet
//   dependencies reaches 0 (a count drops when a dependency completes for
//   the first time) or when a resource it waits on frees.
//
//   admission: the warp takes the (up to) 32 least ready ranks (the set
//   bits of the 32 words from the first word that is not zero), a lane
//   each, and every lane walks its candidate's compacted row, sixteen
//   entries and then their sixteen rooms at a time, to its first resource
//   with no room left; a lone candidate's row is read 32 entries a pass
//   by the whole warp instead. All are checked against the same room: the
//   least that passes is admitted and those before it park. The ready set
//   cannot grow before the next completion, so those after it are checked
//   again against the room it left, and so on: one pass over the window
//   makes as many admission steps as it holds admissible tasks, in rank
//   order, as the reference would. A task that parks joins the wait list
//   of that first full resource, and every completion that frees the
//   resource wakes every waiter (the contract of the numpy engine,
//   fastsim.CompiledSim._run_generic: admissions only take room, so a
//   parked task stays inadmissible until then).
//
//   completion: the running tasks sit unordered in slots, with the least
//   (fin, seq) of each 32 slots kept beside them (seq is unique among
//   running tasks); the least of all is one warp pass over those block
//   keys, with hardware reductions over fin as an ordered 64-bit integer
//   and then seq, and removing it rebuilds one or two block keys. When
//   nothing runs or the least fin is inf, every task's fin is inf, and the
//   reference's argmin falls to the least (seq, index) over all n tasks,
//   which may be a done task (completed again) or an unstarted one: that
//   step, and only that one, scans all n sequence numbers. A completion
//   adds its row back to the room, wakes every waiter of each of its
//   resources (and asks L1 for their rows and durations) and, on a first
//   completion, drops its children's counts.
//
// The wrapper (repro_torch/core/kernelsim.py, compact_structure) relabels
// tasks by rank and drops every entry of a resource whose capacity exceeds
// its occurrences (it can never block: the dummy pad among them), so a row
// is the entries that can block, repeats kept; occupancy is kept as room =
// capacity - occupancy, blocked at room <= 0. Durations are read, and
// results written, in rank order; the wrapper permutes them.
//
// Exactness: the only arithmetic is the float64 add now + dur, written
// as __dadd_rn; the build passes -fmad=false and no fast-math flag
// (repro_torch/nvcc.py). Ties are broken by keys ((fin, seq) among running
// tasks, (seq, index) in the scan, rank in the bitmap), never by arrival
// order; the only atomics are integer adds, ands, ors, mins and exchanges
// whose results do not depend on their order. So completion times are
// bit-identical to the numpy engine's and the reference's.
//
// Memory: the room, the bitmap, the first kRunShared running slots and
// the block keys are always in shared memory; task status, dependency
// counts, the wait lists and the row offsets are too when everything fits
// ("shared" variant), else the first three live in the lane's workspace
// and the offsets are read from the structure ("global" variant), as are
// the running slots past kRunShared. The wrapper picks the variant from n
// and W and the launch sets the dynamic shared-memory size, returning the
// error if refused.
//
// Bound: the 2n steps depend on each other, so the kernel is bound by the
// latency of a step (a chain of shared loads, warp collectives and a few
// L2 loads: a row's entries, its record, a duration), not by its bytes:
// the structure and the durations read once, comp and seqs written once,
// take microseconds at 3.35 TB/s. One lane is one warp (a block); lanes
// run side by side on the SMs. 4 and 32 warps a lane were measured on an
// earlier form of this design and gained nothing once a warp checks 32
// candidates (PERF.md). Launches on the caller's stream and allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

// Built with -DEC_PROFILE, lane 0 of the first block adds the cycles of
// each phase of a step (EC_TICK) and counts of its work (EC_COUNT) into
// ec_profile, which event_core_profile copies out; otherwise both compile
// to nothing.
#ifdef EC_PROFILE
__device__ unsigned long long ec_profile[16];
#define EC_TICK(k)                                                         \
  if (prof_on) {                                                           \
    const long long t_now = clock64();                                     \
    prof[k] += t_now - t_last;                                             \
    t_last = t_now;                                                        \
  }
#define EC_COUNT(k, v) \
  if (prof_on) prof[8 + (k)] += (v);
#define EC_HOP() ++hops;
#else
#define EC_TICK(k)
#define EC_COUNT(k, v)
#define EC_HOP()
#endif

namespace {

constexpr int kBigSeq = INT_MAX;       // _BIG_SEQ: seq of a task not admitted
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRunShared = 1024;       // running-list slots in shared memory
constexpr uint8_t kWait = 0, kReady = 1, kParked = 2, kRun = 3, kDone = 4;

struct __align__(16) Run {             // a running task in its slot
  double fin;
  int seq;
  int p;                               // its rank
};

struct __align__(16) Key {             // a block's least running task
  unsigned long long ord;              // its fin, as order_bits
  int seq;
  int slot;
};

// fin as an unsigned integer of the same order (every number; -0.0 as
// +0.0, which compares equal to it); no key reaches ~0.
__device__ __forceinline__ unsigned long long order_bits(double f) {
  const unsigned long long b = __double_as_longlong(f == 0.0 ? 0.0 : f);
  return b >> 63 ? ~b : b | 0x8000000000000000ull;
}

__device__ __forceinline__ bool less(const Key& a, const Key& b) {
  return a.ord < b.ord || (a.ord == b.ord && a.seq < b.seq);
}

__host__ __device__ inline int run_shared(int n) {
  return n < kRunShared ? n : kRunShared;
}

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// Dynamic shared memory of one block: the running list's shared slots and
// the least key of each 32 slots, room [W], the bitmap [nw] and its
// summary [ns]; with the shared variant also the wait lists' heads [W],
// their links [n], dependency counts [n], the row offsets [n + 1] and
// status [n].
__host__ __device__ inline long long shared_bytes(int n, int W, bool sh) {
  const long long nw = (n + 31) / 32, ns = (nw + 31) / 32;
  long long b = 16LL * run_shared(n) + 16 * nw + 4LL * W + 4 * nw + 4 * ns;
  if (sh) b += 4LL * W + 12LL * n + 4 + n;
  return align16(b);
}

// Workspace of one lane: the running list past kRunShared and, with the
// global variant, the wait lists, dependency counts and status.
__host__ __device__ inline long long work_bytes(int n, int W, bool sh) {
  long long b = 16LL * (n - run_shared(n));
  if (!sh) b += 4LL * W + 8LL * n + n;
  return align16(b);
}

__device__ __forceinline__ void prefetch_l1(const void* ptr) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(ptr));
}

// The least (fin, seq) over the warp's keys, by three hardware reductions
// (the order's high and low words, then seq); every lane gets it. A lane
// with no key passes ord ~0.
__device__ __forceinline__ Key warp_min(const Key& k) {
  const unsigned hi = (unsigned)(k.ord >> 32), lo = (unsigned)k.ord;
  const unsigned m1 = __reduce_min_sync(kFull, hi);
  const unsigned m2 = __reduce_min_sync(kFull, hi == m1 ? lo : ~0u);
  const bool tie = hi == m1 && lo == m2;
  const unsigned m3 = __reduce_min_sync(kFull, tie ? (unsigned)k.seq : ~0u);
  const int w =
      __ffs(__ballot_sync(kFull, tie && (unsigned)k.seq == m3)) - 1;
  return Key{(unsigned long long)m1 << 32 | m2, (int)m3,
             __shfl_sync(kFull, k.slot, w)};
}

// The running tasks, unordered in slots [0, h), the first kRunShared in
// shared memory; key[b] is the least (fin, seq) of slots [32b, 32b + 32).
// A push is one lane's store; finding the least is a warp's pass over the
// block keys, and removing it rebuilds one or two block keys.
struct Running {
  Run* s;
  Run* g;
  Key* key;
  __device__ Run& at(int i) const {
    return i < kRunShared ? s[i] : g[i - kRunShared];
  }
  __device__ void push(int h, const Run& x) const {       // one lane
    at(h) = x;
    const Key k{order_bits(x.fin), x.seq, h};
    if ((h & 31) == 0 || less(k, key[h >> 5])) key[h >> 5] = k;
  }
  __device__ Key least(int h, int ln) const {             // the warp
    Key k{~0ull, kBigSeq, -1};
    for (int b = ln; b < (h + 31) >> 5; b += 32) {
      const Key c = key[b];
      if (less(c, k)) k = c;
    }
    return warp_min(k);
  }
  __device__ void rebuild(int b, int h, int ln) const {
    const int i = (b << 5) + ln;
    Key k{~0ull, kBigSeq, -1};
    if (i < h) {
      const Run r = at(i);
      k = Key{order_bits(r.fin), r.seq, i};
    }
    k = warp_min(k);
    if (ln == 0) key[b] = k;
  }
  // removes slot from h running tasks (the warp); the last moves into it
  __device__ void remove(int slot, int h, int ln) const {
    const int last = h - 1;
    if (ln == 0 && slot != last) at(slot) = at(last);
    __syncwarp();
    if ((slot >> 5) << 5 < last) rebuild(slot >> 5, last, ln);
    if ((last >> 5) != (slot >> 5) && (last & 31))
      rebuild(last >> 5, last, ln);
    __syncwarp();
  }
};

__device__ __forceinline__ void set_ready(unsigned* bits, unsigned* sum,
                                          int p) {
  const int w = p >> 5;
  if (atomicOr(bits + w, 1u << (p & 31)) == 0u)
    atomicOr(sum + (w >> 5), 1u << (w & 31));
}

// The first word of the bitmap that is not zero, or -1; every lane gets
// the answer.
__device__ int first_word(const unsigned* sum, int ns, int ln) {
  for (int base = 0; base < ns; base += 32) {
    const int i = base + ln;
    const unsigned v = i < ns ? sum[i] : 0u;
    const unsigned b = __ballot_sync(kFull, v != 0u);
    if (b) {
      const int f = __ffs(b) - 1;
      return ((base + f) << 5) + __ffs(__shfl_sync(kFull, v, f)) - 1;
    }
  }
  return -1;
}

// The first entry in [a, b) of row_res with no room left, or -1: one
// lane's walk, sixteen entries at a time, their rooms all read before any
// is tested, so a batch costs one load's latency, not sixteen.
__device__ __forceinline__ int walk_row(const int* __restrict__ row_res,
                                        const int* room, int a, int b) {
  for (int k = a; k < b; k += 16) {
    int r[16], q[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      r[u] = k + u < b ? __ldg(row_res + k + u) : -1;
#pragma unroll
    for (int u = 0; u < 16; ++u) q[u] = r[u] >= 0 ? room[r[u]] : 1;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (q[u] <= 0) return r[u];
  }
  return -1;
}

// The same for one row, the warp reading 32 entries a pass and
// __ballot_sync picking the first full one; every lane gets the answer.
__device__ int warp_row(const int* __restrict__ row_res, const int* room,
                        int a, int b, int ln) {
  for (int k = a; k < b; k += 32) {
    const int e = k + ln;
    const int r = e < b ? __ldg(row_res + e) : -1;
    const unsigned m = __ballot_sync(kFull, r >= 0 && room[r] <= 0);
    if (m) return __shfl_sync(kFull, r, __ffs(m) - 1);
  }
  return -1;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// One warp a lane. rank [n] task -> rank, inv [n] rank -> task; row_ptr
// [n + 1] into row_res and ch_ptr [n + 1] into ch; caps [W], dep_n [n]:
// the compacted structure in rank order. durs [L, n] -> comp [L, n],
// seqs [L, n], all three in rank order. The scalars of the loop (now, the
// admission counter, completions, the number running) are kept alike in
// every lane's registers.
template <bool SH>
__global__ void __launch_bounds__(32, 1)
event_core_kernel(const int* __restrict__ rank, const int* __restrict__ inv,
                  const int* __restrict__ row_ptr,
                  const int* __restrict__ row_res,
                  const int* __restrict__ caps, const int* __restrict__ dep_n,
                  const int* __restrict__ ch_ptr,
                  const int* __restrict__ ch, const double* __restrict__ durs,
                  int n, int W, double* comp, int* seqs, unsigned char* work,
                  long long work_lane) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cand[32];

  const int ln = threadIdx.x;
  const long long lane = blockIdx.x;
  durs += lane * n;
  comp += lane * n;
  seqs += lane * n;
  work += lane * work_lane;
  const int nw = (n + 31) >> 5, ns = (nw + 31) >> 5;
  Key* key = reinterpret_cast<Key*>(smem + 16LL * run_shared(n));
  const Running run{reinterpret_cast<Run*>(smem),
                    reinterpret_cast<Run*>(work), key};
  int* room = reinterpret_cast<int*>(key + nw);
  unsigned* bits = reinterpret_cast<unsigned*>(room + W);
  unsigned* sum = bits + nw;
  int* head;
  if constexpr (SH) head = reinterpret_cast<int*>(sum + ns);
  else head = reinterpret_cast<int*>(work + 16LL * (n - run_shared(n)));
  int* next = head + W;
  int* depc = next + n;
  int* rows = depc + n;                // row offsets: shared variant only
  uint8_t* status = reinterpret_cast<uint8_t*>(SH ? rows + n + 1 : rows);
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  // rank p's row: [row_lo(p), row_hi(p)) of row_res
  auto row_lo = [&](int p) { return SH ? rows[p] : __ldg(row_ptr + p); };
  auto row_hi = [&](int p) {
    return SH ? rows[p + 1] : __ldg(row_ptr + p + 1);
  };
  auto warm = [&](int t) {             // a task that just became ready
    prefetch_l1(durs + t);
    if constexpr (SH) prefetch_l1(row_res + rows[t]);
    else prefetch_l1(row_ptr + t);
  };

  for (int r = ln; r < W; r += 32) {
    room[r] = __ldg(caps + r);
    head[r] = -1;
  }
  for (int p = ln; p < n; p += 32) {
    seqs[p] = kBigSeq;
    comp[p] = 0.0;
  }
  if constexpr (SH)
    for (int p = ln; p <= n; p += 32) rows[p] = __ldg(row_ptr + p);
  for (int base = 0; base < nw * 32; base += 32) {
    const int p = base + ln;
    const int d = p < n ? __ldg(dep_n + p) : 1;
    if (p < n) {
      depc[p] = d;
      status[p] = d ? kWait : kReady;
    }
    const unsigned b = __ballot_sync(kFull, d == 0);
    if (ln == 0) bits[base >> 5] = b;
  }
  __syncwarp();
  for (int s = ln; s < ns; s += 32) {
    unsigned v = 0;
    for (int i = 0; i < 32 && s * 32 + i < nw; ++i)
      v |= (bits[s * 32 + i] != 0u ? 1u : 0u) << i;
    sum[s] = v;
  }
  __syncwarp();

  double now = 0.0;
  int ctr = 0, ncomp = 0, h = 0;
#ifdef EC_PROFILE
  const bool prof_on = blockIdx.x == 0 && ln == 0;
  long long prof[16] = {}, t_last = clock64();
#endif
  while (ncomp < n) {
    // admission: the (up to) 32 least ready ranks, the set bits of the 32
    // words from the first one that is not zero, a lane each, checked
    // against the same room
    const int w0 = first_word(sum, ns, ln);
    EC_TICK(0);
    if (w0 >= 0) {
      const int w = w0 + ln;           // this lane's word of the window
      const unsigned v0 = w < nw ? bits[w] : 0u;
      const int c = __popc(v0);
      int inc = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, off);
        if (ln >= off) inc += t;
      }
      const int excl = inc - c;
      unsigned v = v0;
      for (int slot = excl; v && slot < 32; ++slot, v &= v - 1)
        s_cand[slot] = (w << 5) + __ffs(v) - 1;
      const int nc = min(__shfl_sync(kFull, inc, 31), 32);
      __syncwarp();
      const int p = ln < nc ? s_cand[ln] : -1;
      EC_TICK(1);
      EC_COUNT(0, nc);
      int lo = 0, hi = 0;
      double dur = 0.0;
      if (p >= 0) {
        lo = row_lo(p);
        hi = row_hi(p);
        dur = __ldg(durs + p);
      }
      int blk;                         // one rank: the warp walks its row
      if (nc == 1)
        blk = warp_row(row_res, room, __shfl_sync(kFull, lo, 0),
                       __shfl_sync(kFull, hi, 0), ln);
      else
        blk = p >= 0 ? walk_row(row_res, room, lo, hi) : -1;
      EC_TICK(2);
      EC_COUNT(1, 1);
      // the ready set cannot grow before a completion, so the window is
      // resolved here: the least candidate that passes is admitted, those
      // before it park, those after it are checked again against the room
      // the admission left, and so on to the window's end
      for (int start = 0;;) {
        const unsigned ok =
            __ballot_sync(kFull, ln >= start && p >= 0 && blk < 0);
        const int a = ok ? __ffs(ok) - 1 : nc;
        EC_COUNT(2, a - start);
        if (ln >= start && ln < a) {   // park on the first full resource
          status[p] = kParked;
          next[p] = atomicExch(head + blk, p);
        }
        if (a >= nc) break;
        EC_COUNT(4, 1);
        const int e0 = __shfl_sync(kFull, lo, a);
        const int e1 = __shfl_sync(kFull, hi, a);
        for (int k = e0 + ln; k < e1; k += 32)
          atomicSub(room + __ldg(row_res + k), 1);
        if (ln == a) {
          status[p] = kRun;
          seqs[p] = ctr;
          run.push(h, Run{__dadd_rn(now, dur), ctr, p});
        }
        ++h;
        ++ctr;
        start = a + 1;
        if (start >= nc) break;
        __syncwarp();
        EC_COUNT(0, nc - start);
        if (ln >= start) blk = walk_row(row_res, room, lo, hi);
      }
      // every candidate has left the bitmap: clear this lane's word
      unsigned m = 0;
      v = v0;
      for (int slot = excl; v && slot < nc; ++slot, v &= v - 1)
        m |= v & (0u - v);
      if (m) {
        bits[w] = v0 & ~m;
        if (!(v0 & ~m)) atomicAnd(sum + (w >> 5), ~(1u << (w & 31)));
      }
      __syncwarp();
      EC_TICK(3);
      continue;
    }

    // completion: the least running (fin, seq), or the scan of all n keys
    // when nothing runs or the least fin is inf
    int j;
    const Key top = run.least(h, ln);
    if (h > 0 && top.ord != order_bits(inf)) {
      Run r{0.0, 0, 0};
      if (ln == 0) r = run.at(top.slot);
      j = __shfl_sync(kFull, r.p, 0);
      now = __shfl_sync(kFull, r.fin, 0);
      run.remove(top.slot, h, ln);
      --h;
    } else {
      unsigned long long best = ~0ull;
      for (int p = ln; p < n; p += 32) {
        const unsigned long long k =
            ((unsigned long long)(unsigned)seqs[p] << 32) |
            (unsigned)__ldg(inv + p);
        best = k < best ? k : best;
      }
      j = __ldg(rank + (int)(warp_min(best) & 0xffffffffu));
      if (status[j] == kRun) {         // then it is the least running
        run.remove(top.slot, h, ln);
        --h;
      }
      now = inf;
    }
    EC_TICK(4);
    ++ncomp;
    const int st = __shfl_sync(kFull, (int)status[j], 0);   // lane 0's read
    if (ln == 0) {
      comp[j] = now;
      status[j] = kDone;
      if (st == kReady) {
        const int w = j >> 5;
        const unsigned left = bits[w] & ~(1u << (j & 31));
        bits[w] = left;
        if (!left) sum[w >> 5] &= ~(1u << (w & 31));
      }
    }
    __syncwarp();
    EC_TICK(5);
#ifdef EC_PROFILE
    int hops = 0;
#endif
    const int c0 = __ldg(ch_ptr + j), c1 = __ldg(ch_ptr + j + 1);
    for (int k = row_lo(j) + ln, e1 = row_hi(j); k < e1; k += 32) {
      const int r = __ldg(row_res + k);
      atomicAdd(room + r, 1);
      for (int t = atomicExch(head + r, -1); t >= 0;) {   // wake every waiter
        EC_HOP();
        const int nx = next[t];
        if (status[t] == kParked) {
          status[t] = kReady;
          set_ready(bits, sum, t);
          warm(t);
        }
        t = nx;
      }
    }
#ifdef EC_PROFILE
    hops = __reduce_add_sync(kFull, hops);     // every lane, then count
    EC_COUNT(3, hops);
#endif
    EC_TICK(6);
    if (st != kDone) {                 // a first completion
      for (int k = c0 + ln; k < c1; k += 32) {
        const int c = __ldg(ch + k);
        if (atomicSub(depc + c, 1) == 1 && status[c] == kWait) {
          status[c] = kReady;
          set_ready(bits, sum, c);
          warm(c);
        }
      }
    }
    __syncwarp();
    EC_TICK(7);
  }
#ifdef EC_PROFILE
  if (prof_on)
    for (int k = 0; k < 16; ++k) ec_profile[k] = prof[k];
#endif
}

template <bool SH>
int launch(const int* rank, const int* inv, const int* row_ptr,
           const int* row_res, const int* caps, const int* dep_n,
           const int* ch_ptr, const int* ch, const double* durs, int n, int W,
           int L, double* comp, int* seqs, unsigned char* work,
           cudaStream_t stream) {
  const long long smem = shared_bytes(n, W, SH);
  cudaError_t err = cudaFuncSetAttribute(
      event_core_kernel<SH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  event_core_kernel<SH><<<dim3((unsigned)L), dim3(32), (size_t)smem,
                          stream>>>(rank, inv, row_ptr, row_res, caps, dep_n,
                                    ch_ptr, ch, durs, n, W, comp, seqs, work,
                                    work_bytes(n, W, SH));
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block takes for n tasks and W kept resources,
// with the shared (1) or global (0) variant.
extern "C" long long event_core_shared_bytes(int n, int W, int shared) {
  return shared_bytes(n, W, shared != 0);
}

// Workspace bytes a lane takes (a multiple of 16).
extern "C" long long event_core_work_bytes(int n, int W, int shared) {
  return work_bytes(n, W, shared != 0);
}

// The most dynamic shared memory a block of the shared (1) or global (0)
// variant may ask for on the current device: the opt-in limit less the
// kernel's static shared memory; -1 if either cannot be read.
extern "C" int event_core_max_shared(int shared) {
  int dev = 0, optin = 0;
  cudaFuncAttributes at;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&at, shared ? event_core_kernel<true>
                                        : event_core_kernel<false>) !=
          cudaSuccess)
    return -1;
  return optin - (int)at.sharedSizeBytes;
}

// rank int32 [n] (a permutation), inv int32 [n] (its inverse), row_ptr
// int32 [n + 1] and ch_ptr int32 [n + 1] (each rank's row and children as
// offsets into row_res and ch),
// row_res int32 (ids in [0, W)), caps int32 [W], dep_n int32 [n], ch int32
// (ranks): the compacted structure, rank order; durs float64 [L, n], comp
// float64 [L, n] and seqs int32 [L, n] (written) in rank order; work is
// L x event_core_work_bytes(n, W, shared) bytes. All on one device,
// n, L >= 1. One warp a lane. Returns the error of the shared-memory
// attribute or of the launch (0 on success).
extern "C" int event_core(const void* rank, const void* inv,
                          const void* row_ptr, const void* row_res,
                          const void* caps, const void* dep_n,
                          const void* ch_ptr, const void* ch,
                          const void* durs, int n, int W,
                          int L, int shared, void* comp, void* seqs,
                          void* work, void* stream) {
  auto f = shared ? launch<true> : launch<false>;
  return f(static_cast<const int*>(rank), static_cast<const int*>(inv),
           static_cast<const int*>(row_ptr), static_cast<const int*>(row_res),
           static_cast<const int*>(caps), static_cast<const int*>(dep_n),
           static_cast<const int*>(ch_ptr), static_cast<const int*>(ch),
           static_cast<const double*>(durs), n,
           W, L, static_cast<double*>(comp), static_cast<int*>(seqs),
           static_cast<unsigned char*>(work),
           static_cast<cudaStream_t>(stream));
}

#ifdef EC_PROFILE
// The first lane's cycles by phase (0-7) and its counts (8-15) of the last
// launch, into out[16].
extern "C" int event_core_profile(void* out) {
  return (int)cudaMemcpyFromSymbol(out, ec_profile, sizeof(ec_profile));
}
#endif
