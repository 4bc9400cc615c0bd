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
// count as dt = 0. Everything is float32 inside; y is written in x's dtype.
//
// What bounds it. At the prefill shape of Mamba-2 370M (b=4, s=2048, 32
// heads, dh=64, ds=128, chunk 128) a launch must move 202 MB (x, B, C and y
// in bf16, dt in float32): 60 us at 3.35 TB/s. Its arithmetic, 21.5 GFLOP
// counting full C B^T and W x tiles, takes 22 us on the bf16 tensor cores,
// so the card's bound is the bytes. This first version does its products on
// the float32 FMA units (tensor cores would round the float32 decay weights),
// so in practice it is bound by those units and by shared-memory reads.
//
// The design.
// - The TPU grid ran its chunk axis in order and carried h in VMEM scratch
//   from one grid step to the next. CUDA blocks run in no order, so one
//   block owns one (b, h) and loops over the chunks itself; h lives in
//   shared memory (float32) for the whole sequence.
// - Every input is read exactly once from device memory, straight from the
//   model's (b, s, h, .) layout by strides: no transposes or padding copies
//   on the host (the JAX wrapper's moveaxis and pad). The ragged tail of the
//   last chunk is masked at the loads (zeros, dt = 0) and at the stores.
// - A chunk's x, B and C stay in shared memory in the input dtype (bf16:
//   16 + 32 + 32 KB) and are widened to float32 in registers. B and C are
//   stored transposed ([ds][Lp]) so that both products over ds read 4
//   consecutive chunk rows with one vector load.
// - The (Lc x Lc) matrix W = (C B^T) o L o dt is never whole: it is built
//   32 columns at a time (16 KB float32) and consumed at once by y += W x,
//   which keeps the float32 case (x, B, C as float32) under 227 KB. Column
//   blocks right of a row block are skipped (the triangle).
// - Each thread owns 4x4 register tiles: a step of a product reads 8 values
//   from shared memory for 16 FMAs.
//
// Shared-memory layout (smem_bytes below; ssd_scan_smem reports it, and
// ssd_scan_smem_limit the device's limit, to the wrapper): float32 h[ds][dh], W^T[32][Lp], dt[Lp], cum[Lp], sdec[Lp];
// then T x[Lp][dh], B^T[ds][Lp], C^T[ds][Lp]; Lp = Lc rounded up to a
// multiple of 32 (rows past Lc are zero).
//
// Interface: plain C, loaded with ctypes (src/repro_torch/kernels/ssd_scan.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int JB = 32;    // columns of W per pass
constexpr int YT = 4;     // most 4x4 tiles of y a thread owns

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // exact: v was read from a bf16
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, bsz);
  ssd_scan_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), seq, heads, dh, ds, Lc,
      Lp);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for chunk Lc (layout above), or
// -1 where it cannot take Lc x dh (more y tiles than its threads own).
extern "C" long long ssd_scan_smem(int Lc, int dh, int ds, int is_bf16) {
  return smem_bytes(Lc, dh, ds, is_bf16 ? 2 : 4);
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
// (b, s, h), A float32 (h,), chunk Lc. Returns cudaGetLastError() after
// the launch (or the error of setting its shared-memory size).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, void* y, int bsz,
                        int seq, int heads, int dh, int ds, int Lc,
                        int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, bsz, seq, heads, dh, ds,
                                 Lc, s);
  return launch<float>(x, dt, A, B, C, y, bsz, seq, heads, dh, ds, Lc, s);
}
