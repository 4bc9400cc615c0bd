// K2: flash attention (online-softmax attention with GQA) on Hopper
// (sm_90a), one launch per attention layer of a dense prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:30
// (_attn_kernel, launched by flash_attention at :114). It computes the same
// function: q (B, Hq, S, D), k and v (B, Hkv, T, D), q head j*g + i reading
// kv head j (g = Hq / Hkv); with causal, query row r sees key columns
// c <= r + (T - S) (the decode offset); logits scaled by `scale` (float32,
// 1/sqrt(D) by default); an online softmax over the key columns with a
// running max m and sum l, float32 throughout; a fully-masked row gives 0
// (l == 0 -> 1); the output in q's dtype. Every mask is a select, never a
// multiply: 0 * NaN is NaN.
//
// What bounds it. At the dense prefill of llama3.2-3b (B 4, Hq 32 -- of which
// 8 are the TP padding's zero-weighted dummy slots --, Hkv 16, S = T = 2048,
// D 128, bf16, causal) a launch must do 137,506,062,336 FLOP (4 D for every
// (row, col) pair on or under the diagonal: q.k and p.v), 0.1390 ms at
// 989 TFLOP/s on the bf16 tensor cores, and move 201,326,592 B (q, k, v
// and o, each once), 0.0601 ms at 3.35 TB/s. So the card's bound is the
// operations. A quarter of them are the padding's dummy q slots: the
// reference's layout, not the model's.
//
// This first version does its products on the float32 FMA units (exact
// float32 for float32 inputs, as the float32 tolerance of 3e-5 needs; bf16
// inputs are widened on load), so in practice it is bound by those units
// (67 TFLOP/s at most) and by shared-memory reads. Tensor-core products
// (mma.sync / wgmma, with TMA loads) are the later PR that makes K2 fast.
//
// The design.
// - The TPU grid ran (B*Hkv, G, nq, nk) in order and kept m, l and acc in
//   VMEM scratch across its kv axis. CUDA blocks run in no order, so one
//   block owns one (batch, q head, tile of 64 query rows) and runs the kv
//   loop itself; m and l live in registers, acc in registers (a thread owns
//   4 rows x D/16 columns of it).
// - The kv loop stops at the causal limit of the tile's last row,
//   last + (T - S) + 1; the tile on the diagonal and the ragged tails of S
//   and T are masked by a select inside the tile. Tiles are scheduled
//   longest first (the blocks of the last q tiles get the lowest indices),
//   so the short tiles fill the tail. 4,096 blocks at the prefill shape.
// - q, k, v and o are read and written by strides (d contiguous), so the
//   model's (B, S, H, D) projections need no transpose copies.
// - Shared memory (float32): Q^T [D][68] for the block's whole life; one
//   buffer that holds K^T [D][65] for q.k and then V [64][D] for p.v; P^T
//   [64][68]. 85,504 B at D = 128, so two blocks (16 warps) fit on an SM.
//   Q^T and P^T are read 4 rows per float4; K^T's odd pitch makes its fill
//   free of bank conflicts.
// - Each thread owns 4 rows x 4 columns of the 64 x 64 score tile; a row's
//   16 threads are one half-warp, so its max is 4 shuffles. The running sum
//   stays per thread and is summed once at the end.
//
// Interface: plain C, loaded with ctypes
// (src/repro_torch/kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block: 16 x 16
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key columns per step of the kv loop
constexpr int QP = BQ + 4;       // pitch of Q^T and P^T rows (float4 reads)
constexpr int KP = BK + 1;       // pitch of K^T rows (odd: conflict-free fill)
constexpr float NEG = -1e30f;    // the masked logit, as the reference's

struct Strides {                 // elements; the d stride is 1
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);    // round to nearest even, as torch's cast
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int D>
__host__ __device__ constexpr int kv_floats() {
  return D * KP > BK * D ? D * KP : BK * D;
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return D * QP + kv_floats<D>() + BK * QP;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, Strides sq,
            Strides sk, Strides sv, Strides so, int B, int Hq, int group,
            int S, int Tn, float scale, int causal) {
  constexpr int CD = D / 16;     // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][QP]
  float* KV = Qt + D * QP;       // K^T [D][KP], then V [BK][D]
  float* Pt = KV + kv_floats<D>();  // [BK][QP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = nq - 1 - blockIdx.x / (B * Hq);   // longest tiles first
  const int hq = bh % Hq, b = bh / Hq, hk = hq / group;
  const int q0 = qt * BQ;
  const T* qb = q + b * sq.b + hq * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + hq * so.h;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    Qt[d * QP + r] = q0 + r < S ? to_f(qb[(q0 + r) * sq.s + d]) : 0.f;
  }

  // key columns any row of this tile may see
  const int last = min(q0 + BQ, S) - 1;
  const int kend = causal ? max(0, min(Tn, last + (Tn - S) + 1)) : Tn;

  float acc[4][CD], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();             // the last step's p.v is done with KV, Pt
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      KV[d * KP + r] = k0 + r < kend ? to_f(kb[(k0 + r) * sk.s + d]) : 0.f;
    }
    __syncthreads();

    // ---- s = q . k for rows 4ty + i, columns tx + 16 j --------------------
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * QP + 4 * ty);
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KV[d * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(comp(qv, i), kv[j], s[i][j]);
    }

    // ---- mask (select), online softmax, p into P^T -----------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool ok[4];
      float mc = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < kend && (!causal || col <= row + (Tn - S));
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)    // the row's 16 threads
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ps += p;
        Pt[(tx + 16 * j) * QP + 4 * ty + i] = p;
      }
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();             // P^T is whole; K^T is read
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      KV[r * D + d] = k0 + r < kend ? to_f(vb[(k0 + r) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    // ---- acc += p . v ------------------------------------------------------
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + kk * QP + 4 * ty);
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float vv = KV[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(comp(pv, i), vv, acc[i][j]);
      }
    }
  }

  // ---- o = acc / l; a fully-masked row has l == 0 and gives 0 -----------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = lt == 0.f ? 1.f : lt;
    const int row = q0 + 4 * ty + i;
    if (row < S) {
#pragma unroll
      for (int j = 0; j < CD; ++j)
        ob[row * so.s + tx + 16 * j] = from_f<T>(acc[i][j] / lt);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Tn, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + BQ - 1) / BQ) * Hq * B;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  attn_kernel<T, D><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, B, Hq,
      Hq / Hkv, S, Tn, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int S, int Tn, int D, const long long* st,
             float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, Tn, st, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, Tn, st, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, Tn, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, Tn, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// o = attention(q, k, v) for q, k, v and o of one dtype (bf16 when is_bf16,
// else float32), D in {16, 32, 64, 128}. strides: 12 element strides, the
// (batch, head, row) strides of q, k, v and o in that order; the d stride is
// 1. Returns cudaGetLastError() after the launch (or the error of setting
// its shared-memory size, or cudaErrorInvalidValue for a D it does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int S, int T,
                               int D, const long long* strides, float scale,
                               int causal, int is_bf16, void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T, D, strides,
                                   scale, causal, s);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, S, T, D, strides, scale,
                         causal, s);
}
