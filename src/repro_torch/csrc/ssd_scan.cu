// K3: the Mamba-2 SSD chunked scan on Hopper (sm_90a), one launch per
// Mamba-2 layer of a prefill.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:30 (_ssd_kernel,
// launched by ssd_scan at :107). It computes the same function: for every
// (batch b, head h) the sequence is cut into chunks of Lc steps, and per
// chunk, with cum the inclusive cumulative sum of dt over the chunk,
//
//   L(i,j) = exp(A (cum_i - cum_j))  for i >= j, else 0   (selected, never
//            multiplied by a mask: above the diagonal the exp overflows)
//   y_i    = sum_j (C_i . B_j) L(i,j) dt_j x_j + exp(A cum_i) C_i . h_in
//   h_out  = h_in exp(A cum_end) + sum_j exp(A (cum_end - cum_j)) dt_j B_j x_j^T
//
// with h (ds x dh) the state carried from chunk to chunk; steps past seq
// count as dt = 0. y is written in x's dtype.
//
// What bounds it. At the prefill shape of Mamba-2 370M (b=4, s=2048, 32
// heads, dh=64, ds=128, chunk 128, bf16) a launch must move 202,375,296 B
// (x, B, C and y in bf16, dt in float32): 60 us at 3.35 TB/s. Its
// arithmetic, 21.5 GFLOP counting full C B^T and W x tiles, takes 22 us on
// the bf16 tensor cores and 0.32 ms on the float32 FMA units. So the card's
// bound is the bytes, and only the tensor cores leave room to reach it.
//
// Two kernels behind the one entry point, chosen by dtype (never one in
// place of the other):
//
// - bf16: ssd_tc<dh, ds>, chunk-parallel items on wgmma.
//   * Only h is sequential across chunks. Everything else is chunk-local:
//     cum, L, W = (C B^T) o L o dt, y's intra-chunk part and the chunk's own
//     state term S_c = sum_j sdec_j B_j x_j^T (sdec_j = exp(A (cum_end -
//     cum_j)) dt_j). So one work item is one (b, h, chunk): 2,048 items at
//     the prefill shape, one block each, two blocks an SM (84 KB of shared
//     memory and at most 128 registers a thread at dh <= 64), so one item's
//     loads overlap the other's products.
//   * The state hand-off, inside the launch. Each block takes a ticket from
//     a counter (atomicAdd), chunk-major: chunk t / (b h), (b, h) = t % (b
//     h). An item waits only on a smaller ticket, whose block already runs,
//     so no start order of the blocks can deadlock. The item computes G, W,
//     y_diag and S_c first; then one thread waits with an acquire load for
//     the flag of (b, h) to reach its chunk; the block reads h_in from one of
//     two float32 slots of (b, h) (L2-coherent loads: another SM wrote them),
//     writes h_out = h_in exp(A cum_end) + S_c to the other slot, and
//     publishes: stores, __threadfence, barrier, a release store of the
//     flag. Chunk c + 1 writes the slot chunk c read only after chunk c has
//     published. No atomic takes part in a sum: two launches give the same
//     bits.
//   * Products, bf16 in and float32 accumulators, 64-row warpgroup tiles
//     over a 128-row chunk tile (two warpgroups, 64 chunk rows each):
//     G = C B^T (K = ds, both operands K-major in shared memory, exact);
//     W formed in G's registers (the select i >= j and j < nv); y_diag =
//     W x with W the A operand from registers and x the MN-major B operand
//     (the transpose bit, as K2 reads V); S_c = (B o sdec)^T x with the A
//     operand built in registers from B's shared tile; y_off = C h_in with
//     h_in in shared memory (where x and B were); y = y_diag + exp(A cum_i)
//     y_off, rounded once to bf16 at a store masked to the chunk's rows.
//     Column halves of W above the diagonal are skipped.
//   * Why the float32 operands are split. W, B o sdec and h_in are float32;
//     rounded once to bf16 they put 57, 5 and 9 of 1,048,576 outputs of 8
//     prefill-shaped chains outside the 2e-2 abs + rel gate (worst error
//     0.125). Each is split into hi = bf16(v) and lo = bf16(v - hi), one
//     wgmma per term into the same float32 accumulator: 0 outside (worst
//     0.068 against a float64 scan). The split adds 13 GFLOP (34.4 in all,
//     35 us at 989 TFLOP/s), still under the bytes' 60 us.
//   * Loads: cp.async 16-byte copies straight from the model's (b, s, h, .)
//     layout into the swizzled layout wgmma reads (SW = 2 x the row bytes, at
//     most 128 B, as TMA would write it); rows past the chunk are
//     zero-filled by the copy (source size 0) and selected away besides.
//     No tensor maps: the wrapper's host work is two small allocations.
//   * Chunks shorter than a tile (Lc < 128, ragged tails, Lc not a multiple
//     of 16): the second warpgroup skips its rows when the chunk has none,
//     and K steps past the chunk's rows are skipped in 64-row halves.
// - float32: ssd_fma, exact float32 on the FMA units (the port's first
//   K3, unchanged; the float32 tolerance of 3e-5 rules out the split's bf16
//   rounding). One block per (b, h) loops over the chunks itself; h lives
//   in shared memory; W is built 32 columns at a time; 4 x 4 register tiles.
//   Shared memory: float32 h[ds][dh], W^T[32][Lp], dt[Lp], cum[Lp],
//   sdec[Lp]; then x[Lp][dh], B^T[ds][Lp], C^T[ds][Lp]; Lp = Lc rounded up
//   to a multiple of 32 (rows past Lc are zero).
//
// Interface: plain C, loaded with ctypes (src/repro_torch/kernels/ssd_scan.py).
// The wgmma helpers are shared with K2 (csrc/hopper.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ============================ float32: ssd_fma ============================

namespace fma {


constexpr int NT = 256;   // threads per block
constexpr int JB = 32;    // columns of W per pass
constexpr int YT = 4;     // most 4x4 tiles of y a thread owns

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_fma(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int seq, int H,
                int dh, int ds, int Lc, int Lp) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);   // [ds][dh]
  float* Ws = hs + ds * dh;                     // [JB][Lp]: W^T, one pass
  float* dts = Ws + JB * Lp;                    // [Lp]
  float* cums = dts + Lp;                       // [Lp]
  float* sdec = cums + Lp;                      // [Lp]
  T* xs = reinterpret_cast<T*>(sdec + Lp);      // [Lp][dh]
  T* Bt = xs + Lp * dh;                         // [ds][Lp]
  T* Ct = Bt + ds * Lp;                         // [ds][Lp]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a = A[h];
  const int nc = (seq + Lc - 1) / Lc;
  const int dq = dh / 4, sq = ds / 4;
  const int nyt = (Lp / 4) * dq;                // 4x4 tiles of y
  const int nht = sq * dq;                      // 4x4 tiles of h
  const long long row0 = (long long)b * seq;   // first (b, s) row of b

  for (int i = tid; i < ds * dh; i += NT) hs[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Lc;
    const int nv = min(Lc, seq - t0);           // real rows of this chunk
    const int nv4 = (nv + 3) & ~3;

    // ---- load the chunk: x row-major, B and C transposed, dt ------------
    for (int idx = tid; idx < Lp * dq; idx += NT) {
      const int r = idx / dq, g = idx % dq;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nv) v = load4(x + ((row0 + t0 + r) * H + h) * dh + 4 * g);
      store4(xs + r * dh + 4 * g, v);
    }
    for (int idx = tid; idx < Lp * sq; idx += NT) {
      const int r = idx % Lp, g = idx / Lp;     // neighbours: neighbouring r
      float4 vb = make_float4(0.f, 0.f, 0.f, 0.f), vc = vb;
      if (r < nv) {
        const long long off = ((row0 + t0 + r) * H + h) * ds + 4 * g;
        vb = load4(Bm + off);
        vc = load4(Cm + off);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Bt[(4 * g + k) * Lp + r] = from_float<T>(comp(vb, k));
        Ct[(4 * g + k) * Lp + r] = from_float<T>(comp(vc, k));
      }
    }
    for (int r = tid; r < Lp; r += NT)
      dts[r] = r < nv ? dt[(row0 + t0 + r) * H + h] : 0.f;
    __syncthreads();

    // ---- cumulative dt (one warp), and the state weights sdec ------------
    if (tid < 32) {
      const int per = Lp / 32;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        run += dts[tid * per + k];
        cums[tid * per + k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float excl = incl - run;
      const float cend = __shfl_sync(0xffffffffu, incl, 31);
      for (int k = 0; k < per; ++k) {
        const int j = tid * per + k;
        const float cj = cums[j] + excl;
        cums[j] = cj;
        sdec[j] = expf(a * (cend - cj)) * dts[j];
      }
    }
    __syncthreads();
    const float cum_end = cums[Lp - 1];         // rows past nv add dt = 0

    // ---- y = exp(A cum_i) C_i . h_in --------------------------------------
    float acc[YT][4][4];
#pragma unroll
    for (int k = 0; k < YT; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][r][q] = 0.f;
      const int t = tid + k * NT;
      if (t < nyt) {
        const int i0 = (t / dq) * 4, d0 = (t % dq) * 4;
        if (i0 < nv) {
          for (int s = 0; s < ds; ++s) {
            const float4 cv = load4(Ct + s * Lp + i0);
            const float4 hv = load4(hs + s * dh + d0);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[k][r][q] = fmaf(comp(cv, r), comp(hv, q), acc[k][r][q]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float e = expf(a * cums[i0 + r]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[k][r][q] *= e;
          }
        }
      }
    }

    // ---- y += W x, 32 columns of W at a time ------------------------------
    for (int jb = 0; jb < nv; jb += JB) {
      __syncthreads();                          // the last pass read Ws
      const int nw = ((nv4 - jb) / 4) * (JB / 4);
      for (int t = tid; t < nw; t += NT) {
        const int i0 = jb + (t / (JB / 4)) * 4, jj0 = (t % (JB / 4)) * 4;
        float w[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) w[r][q] = 0.f;
        for (int s = 0; s < ds; ++s) {
          const float4 cv = load4(Ct + s * Lp + i0);
          const float4 bv = load4(Bt + s * Lp + jb + jj0);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              w[r][q] = fmaf(comp(cv, r), comp(bv, q), w[r][q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = jb + jj0 + q;
          float o[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            // select: exp(A (cum_i - cum_j)) is inf above the diagonal
            o[r] = i >= j ? w[r][q] * expf(a * (cums[i] - cums[j])) * dts[j]
                          : 0.f;
          }
          store4(Ws + (jj0 + q) * Lp + i0, make_float4(o[0], o[1], o[2], o[3]));
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < YT; ++k) {
        const int t = tid + k * NT;
        if (t >= nyt) continue;
        const int i0 = (t / dq) * 4, d0 = (t % dq) * 4;
        if (i0 < jb || i0 >= nv) continue;
        for (int jj = 0; jj < JB; jj += 4) {
          float4 wv[4], xv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wv[q] = load4(Ws + (jj + q) * Lp + i0);
            xv[q] = load4(xs + (jb + jj + q) * dh + d0);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int p = 0; p < 4; ++p)
                acc[k][r][p] = fmaf(comp(wv[q], r), comp(xv[q], p),
                                    acc[k][r][p]);
        }
      }
    }

    // ---- write y -----------------------------------------------------------
#pragma unroll
    for (int k = 0; k < YT; ++k) {
      const int t = tid + k * NT;
      if (t >= nyt) continue;
      const int i0 = (t / dq) * 4, d0 = (t % dq) * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + r < nv)
          store4(y + ((row0 + t0 + i0 + r) * H + h) * dh + d0,
                 make_float4(acc[k][r][0], acc[k][r][1], acc[k][r][2],
                             acc[k][r][3]));
    }
    __syncthreads();                            // every read of h_in is done

    // ---- h = h exp(A cum_end) + sum_j sdec_j B_j x_j^T --------------------
    const float g_end = expf(a * cum_end);
    for (int t = tid; t < nht; t += NT) {
      const int s0 = (t / dq) * 4, d0 = (t % dq) * 4;
      float ha[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 hv = load4(hs + (s0 + r) * dh + d0);
#pragma unroll
        for (int p = 0; p < 4; ++p) ha[r][p] = comp(hv, p) * g_end;
      }
      for (int j = 0; j < nv4; j += 4) {
        float4 bv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = load4(Bt + (s0 + r) * Lp + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = load4(xs + (j + q) * dh + d0);
        const float4 sd = load4(sdec + j);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float bq = comp(bv[r], q) * comp(sd, q);
#pragma unroll
            for (int p = 0; p < 4; ++p)
              ha[r][p] = fmaf(bq, comp(xv[q], p), ha[r][p]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store4(hs + (s0 + r) * dh + d0,
               make_float4(ha[r][0], ha[r][1], ha[r][2], ha[r][3]));
    }
    __syncthreads();                            // before the next chunk loads
  }
}

int padded_chunk(int Lc) { return (Lc + 31) / 32 * 32; }

// Bytes of the layout above, or -1 where the y tiles of a chunk outnumber
// the YT a thread owns.
long long smem_bytes(int Lc, int dh, int ds, int elem) {
  const long long Lp = padded_chunk(Lc);
  if ((Lp / 4) * (dh / 4) > (long long)NT * YT) return -1;
  return 4 * ((long long)ds * dh + JB * Lp + 3 * Lp) +
         elem * (Lp * dh + 2LL * ds * Lp);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int bsz, int seq, int heads, int dh,
           int ds, int Lc, cudaStream_t stream) {
  const long long bytes = smem_bytes(Lc, dh, ds, (int)sizeof(T));
  if (bytes < 0 || bytes > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int smem = (int)bytes, Lp = padded_chunk(Lc);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, bsz);
  ssd_fma<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), seq, heads, dh, ds, Lc,
      Lp);
  return (int)cudaGetLastError();
}

}  // namespace fma

// ============================== bf16: ssd_tc ===============================

namespace tc {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int NT = 2 * WG;       // two warpgroups, 64 chunk rows each
constexpr int LT = 128;          // rows of the chunk tile (Lc <= 128)
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of a 128-row bf16 tile with D columns, as wgmma
// reads it (and as TMA would write it): NB panels of BOX columns, a panel's
// rows SW bytes apart and swizzled at SW bytes (wgmma layout type LAYOUT).
template <int D>
struct Tile {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int BOX = SW / 2;
  static constexpr int PANEL = LT * SW;
  static constexpr int BYTES = LT * D * 2;
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

// The block's shared memory, from a 1,024-byte-aligned base: the x tile,
// then B and C, then float32 dt, cum and sdec. After the products, h_in's
// hi and lo halves (ds rows x dh, laid out like x) take x's and B's place.
template <int DH, int DS>
struct Lay {
  using X = Tile<DH>;
  using S = Tile<DS>;
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X::BYTES;
  static constexpr int C_OFF = B_OFF + S::BYTES;
  static constexpr int F_OFF = C_OFF + S::BYTES;
  static constexpr int H_PANEL = DS * X::SW;     // a panel of h's layout
  static constexpr int H_BYTES = DS * DH * 2;    // one of h's halves
  static constexpr int SMEM = F_OFF + 3 * LT * 4 + 1024;
  // two blocks an SM where the registers allow (at most 128 a thread)
  static constexpr int MINB = DH <= 64 ? 2 : 1;
  static_assert(2 * H_BYTES <= X::BYTES + S::BYTES, "h does not fit");
};

// A byte offset inside a panel of SW-byte rows, swizzled as wgmma reads it
// (16-byte chunk k of row r at k ^ (r mod SW / 16), in groups of rows).
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// 16 bytes from global to shared memory; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma's operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// v0, v1 split into bf16 pairs hi = bf16(v) and lo = bf16(v - hi).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// One 128-row tile of a (b, s, h, D) bf16 tensor, rows row0 .. row0 + 127
// of head h, into its swizzled shared layout; rows from nv on are zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row0, int H, int h,
                                          int nv, int tid) {
  using T = Tile<D>;
  constexpr int CPR = D / 8, CPP = T::SW / 16;   // chunks a row, a panel row
#pragma unroll 4
  for (int i = tid; i < LT * CPR; i += NT) {
    const int r = i / CPR, k = i % CPR;
    const bool ok = r < nv;
    const __nv_bfloat16* s = src + ((row0 + (ok ? r : 0)) * H + h) * D + 8 * k;
    cp_async16(dst + (k / CPP) * T::PANEL +
                   swz<T::SW>(r * T::SW + 16 * (k % CPP)),
               s, ok ? 16 : 0);
  }
}

// One block per work item (b, h, chunk), taken by ticket from work[0];
// work[1 + b H + h] is the flag of (b, h): the chunks published so far. Both
// are 0 at launch. slots: float32 [2][b H][DS][DH], no initial value.
template <int DH, int DS>
__global__ void __launch_bounds__(NT, Lay<DH, DS>::MINB)
ssd_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
       const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
       int bsz, int seq, int H, int Lc, int nc, int* work, float* slots) {
  using X = Tile<DH>;
  using S = Tile<DS>;
  using L = Lay<DH, DS>;
  constexpr int MT = (DS + 63) / 64;     // 64-row tiles of the state
  extern __shared__ uint8_t smem_raw[];
  __shared__ int ticket;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);       // base, as a pointer
  float* dts = reinterpret_cast<float*>(gbase + L::F_OFF);
  float* cums = dts + LT;
  float* sdec = cums + LT;
  const int tid = threadIdx.x;

  if (tid == 0) ticket = atomicAdd(work, 1);
  __syncthreads();
  const int BH = bsz * H, c = ticket / BH, bh = ticket % BH;
  const int b = bh / H, h = bh % H;
  const int nv = min(Lc, seq - c * Lc);           // real rows of the chunk
  const long long row0 = (long long)b * seq + (long long)c * Lc;
  const float a2 = A[h] * LOG2E;

  load_tile<DH>(base + L::X_OFF, x, row0, H, h, nv, tid);
  load_tile<DS>(base + L::B_OFF, Bm, row0, H, h, nv, tid);
  load_tile<DS>(base + L::C_OFF, Cm, row0, H, h, nv, tid);

  // ---- dt (0 past the chunk), its inclusive cumsum, sdec: one warp ------
  if (tid < 32) {
    float v[4], part[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * tid + k;
      v[k] = j < nv ? dt[(row0 + j) * H + h] : 0.f;
      run += v[k];
      part[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += u;
    }
    const float excl = incl - run;
    const float cend = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * tid + k;
      const float cj = part[k] + excl;
      dts[j] = v[k];
      cums[j] = cj;
      sdec[j] = ex2(a2 * (cend - cj)) * v[k];
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int w = tid / WG, lane = tid % 32;
  const int r = 16 * ((tid % WG) / 32) + lane / 4;  // row in a 64-row tile
  const int cq = 2 * (lane % 4);      // the thread's columns in each 8
  const int i0 = 64 * w + r;          // its chunk rows: i0 and i0 + 8
  const bool rows_live = 64 * w < nv;
  float yacc[DH / 2];
#pragma unroll
  for (int k = 0; k < DH / 2; ++k) yacc[k] = 0.f;
  auto desc_x = [&](int k) {          // x rows 16 k .. 16 k + 15
    return desc(base + L::X_OFF + k * 16 * X::SW, X::PANEL, 8 * X::SW,
                X::LAYOUT);
  };
  auto desc_c = [&](int kk) {         // C rows 64 w .., ds 16 kk ..
    return desc(base + L::C_OFF + 64 * w * S::SW +
                    (kk * 32 / S::SW) * S::PANEL + (kk * 32) % S::SW,
                16, 8 * S::SW, S::LAYOUT);
  };

  // ---- y_diag = W x, in column halves of 64 (none above the diagonal) ----
  if (rows_live) {
    const float ci[2] = {cums[i0], cums[i0 + 8]};
    for (int hf = 0; hf <= w && 64 * hf < nv; ++hf) {
      float g[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) g[k] = 0.f;
      fence_regs(g);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk)
        mma_ss<64, 0>(g, desc_c(kk),
                      desc(base + L::B_OFF + 64 * hf * S::SW +
                               (kk * 32 / S::SW) * S::PANEL + (kk * 32) % S::SW,
                           16, 8 * S::SW, S::LAYOUT),
                      kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(g);
      // W = G o L o dt, selected: exp(A (cum_i - cum_j)) is inf above the
      // diagonal
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 64 * hf + 8 * q + cq + e;
          const float cj = cums[j], dj = dts[j];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& v = g[4 * q + 2 * hh + e];
            const float wv = v * ex2(a2 * (ci[hh] - cj)) * dj;
            v = i0 + 8 * hh >= j && j < nv ? wv : 0.f;
          }
        }
      uint32_t wh[4][4], wl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          split2(g[8 * kk + 2 * k], g[8 * kk + 2 * k + 1], wh[kk][k],
                 wl[kk][k]);
      fence_regs(yacc);
      fence_regs(wh);
      fence_regs(wl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<DH>(yacc, wh[kk], desc_x(4 * hf + kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<DH>(yacc, wl[kk], desc_x(4 * hf + kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yacc);
    }
  }

  // ---- S_c = (B o sdec)^T x: state rows 64 w .., in halves of 64 steps ---
  const int s0 = 64 * w + r;          // the thread's state rows s0, s0 + 8
  float sacc[DH / 2];
#pragma unroll
  for (int k = 0; k < DH / 2; ++k) sacc[k] = 0.f;
  if (w < MT) {
    for (int hf = 0; hf < 2 && 64 * hf < nv; ++hf) {
      uint32_t bh_[4][4], bl_[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = s0 + 8 * (k & 1);
          const int j = 64 * hf + 16 * kk + cq + 8 * (k >> 1);
          float v[2] = {0.f, 0.f};
          if (s < DS) {
            const uint8_t* col = gbase + L::B_OFF + (s / S::BOX) * S::PANEL;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t off =
                  swz<S::SW>((j + e) * S::SW + (s % S::BOX) * 2);
              v[e] = __bfloat162float(
                         *reinterpret_cast<const __nv_bfloat16*>(col + off)) *
                     sdec[j + e];
            }
          }
          split2(v[0], v[1], bh_[kk][k], bl_[kk][k]);
        }
      fence_regs(sacc);
      fence_regs(bh_);
      fence_regs(bl_);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<DH>(sacc, bh_[kk], desc_x(4 * hf + kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<DH>(sacc, bl_[kk], desc_x(4 * hf + kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
    }
  }

  // ---- the hand-off: wait for chunk c - 1, h_out to the other slot -------
  __syncthreads();                    // every product read x and B
  int* flag = work + 1 + bh;
  if (tid == 0 && c > 0)
    while (ld_acquire(flag) < c) __nanosleep(64);
  __syncthreads();
  if (w < MT) {
    const float gend = ex2(a2 * cums[LT - 1]);   // rows past nv add dt = 0
    const float* hin = slots + ((size_t)(c & 1) * BH + bh) * DS * DH;
    float* hout = slots + ((size_t)((c + 1) & 1) * BH + bh) * DS * DH;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = s0 + 8 * hh;
      if (s >= DS) continue;
#pragma unroll
      for (int q = 0; q < DH / 8; ++q) {
        const int d = 8 * q + cq;
        const float2 hv = c > 0 ? __ldcg(reinterpret_cast<const float2*>(
                                      hin + s * DH + d))
                                : make_float2(0.f, 0.f);
        if (c < nc - 1)
          __stcg(reinterpret_cast<float2*>(hout + s * DH + d),
                 make_float2(fmaf(hv.x, gend, sacc[4 * q + 2 * hh]),
                             fmaf(hv.y, gend, sacc[4 * q + 2 * hh + 1])));
        // h_in's hi and lo halves, MN-major (ds rows, dh columns)
        const int off = (d / X::BOX) * L::H_PANEL +
                        swz<X::SW>(s * X::SW + (d % X::BOX) * 2);
        if (c > 0) {
          uint32_t hi, lo;
          split2(hv.x, hv.y, hi, lo);
          *reinterpret_cast<uint32_t*>(gbase + off) = hi;
          *reinterpret_cast<uint32_t*>(gbase + L::H_BYTES + off) = lo;
        }
      }
    }
  }
  __threadfence();
  fence_proxy_async();
  __syncthreads();
  if (tid == 0 && c < nc - 1) st_release(flag, c + 1);

  // ---- y = y_diag + exp(A cum_i) C_i . h_in, rounded once to bf16 -------
  if (!rows_live) return;
  if (c > 0) {
    float yo[DH / 2];
#pragma unroll
    for (int k = 0; k < DH / 2; ++k) yo[k] = 0.f;
    fence_regs(yo);
    wgmma_fence();
#pragma unroll
    for (int hl = 0; hl < 2; ++hl)
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk)
        mma_ss<DH, 1>(yo, desc_c(kk),
                      desc(base + hl * L::H_BYTES + kk * 16 * X::SW,
                           L::H_PANEL, 8 * X::SW, X::LAYOUT),
                      hl + kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yo);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float e = ex2(a2 * cums[i0 + 8 * hh]);
#pragma unroll
      for (int q = 0; q < DH / 8; ++q) {
#pragma unroll
        for (int k = 4 * q + 2 * hh; k < 4 * q + 2 * hh + 2; ++k)
          yacc[k] = fmaf(e, yo[k], yacc[k]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + 8 * hh;
    if (i >= nv) continue;
    __nv_bfloat16* yr = y + ((row0 + i) * H + h) * DH;
#pragma unroll
    for (int q = 0; q < DH / 8; ++q)
      *reinterpret_cast<__nv_bfloat162*>(yr + 8 * q + cq) =
          __floats2bfloat162_rn(yacc[4 * q + 2 * hh],
                                yacc[4 * q + 2 * hh + 1]);
  }
}

// work: 1 + bsz H ints, 0 at launch; slots: 2 bsz H DS DH floats.
template <int DH, int DS>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int bsz, int seq, int heads, int Lc,
           int* work, float* slots, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  const int smem = Lay<DH, DS>::SMEM;
  const int err = set_smem_once((const void*)ssd_tc<DH, DS>, smem, smem_set);
  if (err != (int)cudaSuccess) return err;
  if (Lc < 1 || Lc > LT) return (int)cudaErrorInvalidValue;
  const int nc = (seq + Lc - 1) / Lc;
  const long long items = (long long)nc * bsz * heads;
  if (items == 0) return (int)cudaSuccess;
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  ssd_tc<DH, DS><<<(unsigned)items, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<__nv_bfloat16*>(y),
      bsz, seq, heads, Lc, nc, work, slots);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of ssd_tc<dh, ds>, or -1 for a pair it does not
// take.
int smem_bytes(int dh, int ds) {
#define K3_SMEM(DH)                                              \
  case DH:                                                       \
    return ds == 16    ? Lay<DH, 16>::SMEM                       \
           : ds == 32  ? Lay<DH, 32>::SMEM                       \
           : ds == 64  ? Lay<DH, 64>::SMEM                       \
           : ds == 128 ? Lay<DH, 128>::SMEM                      \
                       : -1;
  switch (dh) {
    K3_SMEM(32)
    K3_SMEM(64)
    K3_SMEM(128)
    default: return -1;
  }
#undef K3_SMEM
}

}  // namespace tc

}  // namespace

// Dynamic shared memory a launch needs: for bf16 (the tensor-core kernel)
// at dh in {32, 64, 128}, ds in {16, 32, 64, 128} and Lc <= 128, else -1;
// for float32 (the FMA kernel) the layout above, or -1 where it cannot take
// Lc x dh (more y tiles than its threads own).
extern "C" long long ssd_scan_smem(int Lc, int dh, int ds, int is_bf16) {
  if (is_bf16) return Lc >= 1 && Lc <= tc::LT ? tc::smem_bytes(dh, ds) : -1;
  return fma::smem_bytes(Lc, dh, ds, 4);
}

// Shared memory a block of the current device may opt in to, or -1.
extern "C" int ssd_scan_smem_limit(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

// y = SSD(x, dt, A, B, C) for x, B, C and y of one dtype (bf16 when
// is_bf16, else float32) in the contiguous (b, s, h, .) layout, dt float32
// (b, s, h), A float32 (h,), chunk Lc. For bf16, work is 1 + bsz heads
// ints in device memory, all 0 at launch (the ticket counter and the flags
// of the state hand-off), and slots 2 bsz heads ds dh floats (the carried
// states); float32 reads neither. Returns cudaGetLastError() after the
// launch, the error of setting its shared-memory size, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, void* y, int bsz,
                        int seq, int heads, int dh, int ds, int Lc,
                        int is_bf16, void* work, void* slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return fma::launch<float>(x, dt, A, B, C, y, bsz, seq, heads, dh, ds, Lc,
                              s);
  int* wk = static_cast<int*>(work);
  float* sl = static_cast<float*>(slots);
#define K3_ARGS x, dt, A, B, C, y, bsz, seq, heads, Lc, wk, sl, s
#define K3_CASE(DH, DS) \
  case DH * 1000 + DS: return tc::launch<DH, DS>(K3_ARGS);
  switch (dh * 1000 + ds) {
    K3_CASE(32, 16) K3_CASE(32, 32) K3_CASE(32, 64) K3_CASE(32, 128)
    K3_CASE(64, 16) K3_CASE(64, 32) K3_CASE(64, 64) K3_CASE(64, 128)
    K3_CASE(128, 16) K3_CASE(128, 32) K3_CASE(128, 64) K3_CASE(128, 128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K3_CASE
#undef K3_ARGS
}
