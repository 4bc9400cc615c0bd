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
// operations, and only the tensor cores reach it: the float32 FMA units
// peak at 67 TFLOP/s, 2.05 ms for the same work. Beside the products, each
// (row, key) pair costs the softmax an exp2 on the special-function units
// (16 a clock per SM, half the tensor cores' time for a 128 x 128 tile at
// D 128), and each tile a wait for its K and V; the design keeps the
// tensor cores fed through both.
//
// Two kernels behind the one entry point, chosen by dtype (never one in
// place of the other):
//
// - bf16: attn_tc, warp-specialised for the tensor cores (wgmma) and TMA.
//   * Work items are (batch, q head, tile of 128 query rows); the TPU grid
//     carried m, l and acc in VMEM across its kv axis, here one block runs
//     an item's kv loop itself. The kernel is persistent: one block per SM
//     takes items from a counter in device memory, longest causal tiles
//     first within sections of heads whose K and V fit 16 MB of L2, so the
//     next item's loads overlap the current one's last tiles and blocks
//     that share K and V run together.
//   * Three warpgroups: a producer and two consumers of 64 rows each
//     (wgmma's M). setmaxnreg moves registers from the producer (40) to the
//     consumers (232), which hold the 64 x 128 score tile, P and the 64 x D
//     accumulator in registers (168 a thread at launch, no spills).
//   * The producer's one thread brings Q once per item and K, V through a
//     ring of two stages of 128 keys with TMA (cp.async.bulk.tensor over the
//     strided 4-d view (D, S, H, B), so the model's (B, S, H, D) projections
//     need no copy), each arrival signalled on an mbarrier; K and V are
//     released apart, by one arrival per consumer warp. Shared memory at
//     D 128: 32 KB of Q + 2 x 64 KB of K and V.
//   * S = Q K^T: wgmma m64n128k16 (bf16 -> f32), both operands from shared
//     memory, K-major, swizzled as TMA wrote them (128 B a row; 64 and 32 B
//     at D 32 and 16; D 128 is two 64-column panels).
//   * O += P V: P, rounded to bf16 (as FA2 and FA3 do), is the A operand
//     straight from the score registers (wgmma's accumulator layout is its
//     A-fragment layout for 16-bit types); V is the MN-major B operand, read
//     in its natural keys x D layout with the transpose bit.
//   * Overlap: a consumer issues tile j's Q K^T together with tile j - 1's
//     P V and runs tile j's softmax while that P V finishes; the two
//     consumers take turns on the tensor cores (named barriers), so one's
//     products run while the other's softmax does. Nothing branches while a
//     wgmma is in flight (ptxas would serialise the wgmmas).
//   * The online softmax in registers: a row of the accumulator lies on the
//     four threads of a quad, so its max is two shuffles; p = exp2(s *
//     scale log2 e - m) is one FFMA and one exp2. Masks (ragged tails, the
//     diagonal) are selects to -1e30 and p to 0, compiled in only for the
//     tiles that cross a limit: a zero-filled key past T still scores 0.
//   * O is divided by l in registers and stored by strides.
//   * D 112 runs the D 128 instance, attn_tc<128, 112>, on tensor maps
//     whose inner dimension is 112: TMA fills columns 112-127 of each box
//     with zeros, so Q K^T is exact and P V gives zeros there, and the
//     epilogue stores only the first 112 columns. The 224-byte row stride
//     is a multiple of 16, as TMA needs; the scale stays 1/sqrt(112).
// - float32: attn_fma, exact float32 on the FMA units (the float32
//   tolerance of 3e-5 rules out TF32). One block per (batch, q head, 64
//   query rows), longest causal tiles first; Q^T, K^T then V, and P^T in
//   shared memory (85,504 B at D 128, two blocks per SM); a thread owns 4
//   rows x 4 columns of the 64 x 64 score tile and 4 rows x D/16 columns of
//   the accumulator. D 112 is an instance of its own (7 columns a thread).
//
// Interface: plain C, loaded with ctypes
// (src/repro_torch/kernels/flash_attention.py). The tensor maps are built on
// the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: cuda.h gives the types only, nothing links the
// driver library.
// The wgmma helpers are shared with K3 (csrc/hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;    // the masked logit, as the reference's

struct Strides {                 // elements; the d stride is 1
  long long b, h, s;
};

// ============================ float32: attn_fma ============================

namespace fma {

constexpr int NT = 256;          // threads per block: 16 x 16
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key columns per step of the kv loop
constexpr int QP = BQ + 4;       // pitch of Q^T and P^T rows (float4 reads)
constexpr int KP = BK + 1;       // pitch of K^T rows (odd: conflict-free fill)

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int D>
__host__ __device__ constexpr int kv_floats() {
  return D * KP > BK * D ? D * KP : BK * D;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (D * QP + kv_floats<D>() + BK * QP) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
attn_fma(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ o, Strides sq,
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
  const float* qb = q + b * sq.b + hq * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + hq * so.h;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    Qt[d * QP + r] = q0 + r < S ? qb[(q0 + r) * sq.s + d] : 0.f;
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
      KV[d * KP + r] = k0 + r < kend ? kb[(k0 + r) * sk.s + d] : 0.f;
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
      KV[r * D + d] = k0 + r < kend ? vb[(k0 + r) * sv.s + d] : 0.f;
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
        ob[row * so.s + tx + 16 * j] = acc[i][j] / lt;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Tn, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  const int err = set_smem_once((const void*)attn_fma<D>, smem_bytes<D>(),
                                smem_set);
  if (err != (int)cudaSuccess) return err;
  const long long blocks = (long long)((S + BQ - 1) / BQ) * Hq * B;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  attn_fma<D><<<(unsigned)blocks, NT, smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
      B, Hq, Hq / Hkv, S, Tn, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fma

// ============================= bf16: attn_tc ===============================

namespace tc {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int NT = 3 * WG;       // the producer and two consumers
constexpr int BQ = 128;          // query rows per block, 64 per consumer
constexpr int BK = 128;          // keys per kv tile
constexpr int NS = 2;            // stages of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
// K and V bytes a section of the schedule keeps in L2 (of 50 MB)
constexpr long long L2_BYTES = 16ll << 20;

// Shared-memory geometry of one 128-row tile (Q, K or V) at head dim D, as
// TMA writes it: NB panels of BOX columns, a panel's rows SW bytes apart and
// swizzled at SW bytes (the wgmma layout type LAYOUT).
template <int D>
struct Tile {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int BOX = SW / 2;
  static constexpr int NB = D / BOX;
  static constexpr int PANEL = 128 * SW;
  static constexpr int BYTES = 128 * D * 2;
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  // Q and NS stages of K and V, and room to align the base to 1,024 B
  static constexpr int SMEM = (1 + 2 * NS) * BYTES + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// A predicated arrival (no branch: it may run while a wgmma is in flight).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}

// Named barrier `id` (1 and 2; 0 is __syncthreads) over the two consumers:
// one waits for its turn on it, the other passes the turn to it.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * WG) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * WG) : "memory");
}

// sc = Q K^T for one kv tile: D / 16 steps of 16 columns (32 B of a swizzled
// row; past SW bytes, the next panel).
template <int D>
__device__ __forceinline__ void mma_qk(float (&sc)[BK / 2], uint32_t qa,
                                       uint32_t kt) {
  using L = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk * 32 / L::SW) * L::PANEL + (kk * 32) % L::SW;
    mma_ss<128, 0>(sc, desc(qa + at, 16, 8 * L::SW, L::LAYOUT),
           desc(kt + at, 16, 8 * L::SW, L::LAYOUT), kk);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// acc += P V for one kv tile: 8 steps of 16 keys; V is MN-major, its
// 64-column panels LBO apart and its groups of 8 keys SBO apart.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2],
                                       const uint32_t (&pa)[BK / 16][4],
                                       uint32_t vt) {
  using L = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_rs<D>(acc, pa[kk],
              desc(vt + kk * 16 * L::SW, L::PANEL, 8 * L::SW, L::LAYOUT));
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// The online softmax over one tile of scores for this thread's two rows
// (r, r + 8): mask columns past lim[h] (a select; MASK only on a tile that
// crosses a limit), the new max by the row's quad, in the log2 domain (m is
// the max of s * scale2, and p = exp2(s * scale2 - m) one FFMA and one
// exp2), p in place, l and m updated; alpha gets the factors exp2(m_old -
// m_new) that the accumulator still owes. Straight-line code: it runs while
// the previous tile's P.V is on the tensor cores.
template <bool MASK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const int (&lim)[2], int k0, int cq,
                                        float scale2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * h + e];
        if (MASK) x = k0 + 8 * i + cq + e <= lim[h] ? x : NEG;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[h], mx * scale2);
    alpha[h] = ex2(m[h] - mn);
    m[h] = mn;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * h + e];
        x = ex2(fmaf(x, scale2, -mn));
        if (MASK) x = k0 + 8 * i + cq + e <= lim[h] ? x : 0.f;
        ps += x;
      }
    l[h] = l[h] * alpha[h] + ps;
  }
}

// P for keys 16 kk .. 16 kk + 15 as wgmma's A fragment, two keys a
// register: (r, cq), (r + 8, cq), (r, cq + 8), (r + 8, cq + 8).
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[4 * i + x] *= alpha[x / 2];
}

// One work item: a (batch, q head, tile of 128 query rows). Items are
// numbered in sections of `sect` (batch, q head) pairs, which run together
// so that the K and V they share stay in L2; within a section, longest
// causal tiles first.
struct Item {
  int b, hq, q0, nkv;
};

__device__ __forceinline__ Item item_of(int w, int B, int Hq, int S, int Tn,
                                        int causal, int sect) {
  const int nq = (S + BQ - 1) / BQ, pairs = B * Hq;
  const int sec = w / (sect * nq), in = w % (sect * nq);
  const int width = min(sect, pairs - sec * sect);   // pairs in the section
  const int bh = sec * sect + in % width;
  Item it;
  it.b = bh / Hq;
  it.hq = bh % Hq;
  it.q0 = (nq - 1 - in / width) * BQ;
  // key columns any row of the tile may see
  const int last = min(it.q0 + BQ, S) - 1;
  const int kend = causal ? max(0, min(Tn, last + Tn - S + 1)) : Tn;
  it.nkv = (kend + BK - 1) / BK;
  return it;
}

// A persistent kernel: gridDim.x blocks (at most one per SM) take the
// `items` work items in turn, the first by their index and the rest from
// the counter *next (0 at launch). It computes at head dim D and stores the
// first DV columns (DV < D: the tensor maps' inner dimension is DV and TMA
// fills the rest of each box with zeros).
template <int D, int DV>
__global__ void __launch_bounds__(NT, 1)
attn_tc(const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
        Strides so, int B, int Hq, int group, int S, int Tn, float scale2,
        int causal, int sect, int items, int* __restrict__ next) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  // Q arrived, Q free; then for each stage s: K arrived, V arrived, K free,
  // V free
  __shared__ __align__(8) uint64_t bars[2 + 4 * NS];
  __shared__ int item_now;                   // the item whose Q is loaded
  // tile 0 is Q, tile 1 + 2 s is K of stage s and 2 + 2 s its V
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]), free_q = smem_u32(&bars[1]);
  auto bar_k = [&](int s) { return smem_u32(&bars[2 + s]); };
  auto bar_v = [&](int s) { return smem_u32(&bars[2 + NS + s]); };
  auto free_k = [&](int s) { return smem_u32(&bars[2 + 2 * NS + s]); };
  auto free_v = [&](int s) { return smem_u32(&bars[2 + 3 * NS + s]); };
  auto tile_k = [&](int s) { return base + (1 + 2 * s) * L::BYTES; };
  const int tid = threadIdx.x, off = Tn - S;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(free_q, 2 * WG / 32);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(free_k(s), 2 * WG / 32);
      mbar_init(free_v(s), 2 * WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < WG) {                // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int g = 0;                 // kv tiles loaded so far, over all items
      for (int n = 0, w = blockIdx.x;;
           ++n, w = gridDim.x + atomicAdd(next, 1)) {
        if (n > 0) mbar_wait(free_q, (n - 1) & 1);
        if (w >= items) {        // no more work: the consumers stop
          item_now = -1;
          mbar_arrive(bar_q);
          break;
        }
        const Item it = item_of(w, B, Hq, S, Tn, causal, sect);
        const int hk = it.hq / group;
        item_now = w;
        mbar_expect_tx(bar_q, L::BYTES);
        for (int p = 0; p < L::NB; ++p)
          tma_load(base + p * L::PANEL, &tq, p * L::BOX, it.q0, it.hq, it.b,
                   bar_q);
        for (int j = 0; j < it.nkv; ++j, ++g) {
          const int s = g % NS, parity = (g / NS - 1) & 1;
          if (g >= NS) mbar_wait(free_k(s), parity);
          mbar_expect_tx(bar_k(s), L::BYTES);
          for (int p = 0; p < L::NB; ++p)
            tma_load(tile_k(s) + p * L::PANEL, &tk, p * L::BOX, j * BK, hk,
                     it.b, bar_k(s));
          if (g >= NS) mbar_wait(free_v(s), parity);
          mbar_expect_tx(bar_v(s), L::BYTES);
          for (int p = 0; p < L::NB; ++p)
            tma_load(tile_k(s) + L::BYTES + p * L::PANEL, &tv, p * L::BOX,
                     j * BK, hk, it.b, bar_v(s));
        }
      }
    }
    return;
  }

  // ---- consumers: rows q0 + 64 c .. + 63 of each item ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = tid / WG - 1, t = tid % WG, lane = t % 32;
  const int cq = 2 * (lane % 4);   // the thread's columns in each group of 8
  // Q rows of this consumer, K-major (the A operand of q.k)
  const uint32_t qa = base + 64 * c * L::SW;
  // The consumers take turns on the tensor cores (named barrier 1 + c is
  // consumer c's turn): one issues its products while the other runs its
  // softmax. Consumer 0 goes first; in each item both take phases(nkv)
  // turns, one per issue of products, so the turns alternate across items;
  // consumer 0 ends with a wait that consumer 1's last pass ends.
  auto phases = [](int n) { return n > 0 ? n + 1 : 0; };
  auto turn = [&]() { turn_wait(1 + c); };
  auto pass = [&]() { turn_pass(2 - c); };
  if (c == 1) turn_pass(1);

  float acc[D / 2], sc[BK / 2], m[2], l[2], alpha[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  int g = 0;                     // kv tiles taken so far, over all items
  for (int n = 0;; ++n) {
    mbar_wait(bar_q, n & 1);
    const int w = item_now;
    if (w < 0) break;
    const Item it = item_of(w, B, Hq, S, Tn, causal, sect);
    const int nkv = it.nkv;
    const int row0 = it.q0 + 64 * c;         // the consumer's first row
    // the thread's rows r and r + 8, and the last key column each sees
    const int r = row0 + 16 * (t / 32) + lane / 4;
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lim[h] = causal ? min(Tn - 1, r + 8 * h + off) : Tn - 1;
    // tiles from jm on cross T or, causal, the limit of the consumer's
    // first row: they need masks
    const int jm = causal ? max(0, min(Tn / BK, (row0 + off + 1) / BK))
                          : Tn / BK;
    // the item's last tile may hold no key of the lower half's rows
    const int kend_c =
        causal ? max(0, min(Tn, min(row0 + 63, S - 1) + off + 1)) : Tn;
    const int nc = max(nkv - 1, (kend_c + BK - 1) / BK);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;

    if (nc > 0) {
      // tile 0: scores and softmax (the accumulator is still 0)
      mbar_wait(bar_k(g % NS), (g / NS) & 1);
      turn();
      wgmma_fence();
      mma_qk<D>(sc, qa, tile_k(g % NS));
      pass();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive_if(free_k(g % NS), lane == 0);
      mbar_arrive_if(free_q, lane == 0 && nc == 1);
      if (jm == 0)
        softmax<true>(sc, m, l, alpha, lim, 0, cq, scale2);
      else
        softmax<false>(sc, m, l, alpha, lim, 0, cq, scale2);
      pack_p(pa, sc);
      // tile j's scores run on the tensor cores beside tile j - 1's P.V,
      // and its softmax while that P.V finishes; nothing branches while a
      // wgmma is in flight
      auto step = [&](int j, auto mask) {
        const int s = (g + j) % NS, sp = (g + j - 1) % NS;
        fence_regs(acc);
        fence_regs(pa);
        mbar_wait(bar_k(s), ((g + j) / NS) & 1);
        mbar_wait(bar_v(sp), ((g + j - 1) / NS) & 1);
        turn();
        wgmma_fence();
        mma_qk<D>(sc, qa, tile_k(s));
        mma_pv<D>(acc, pa, tile_k(sp) + L::BYTES);
        pass();
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive_if(free_k(s), lane == 0);
        mbar_arrive_if(free_q, lane == 0 && j == nc - 1);
        softmax<decltype(mask)::value>(sc, m, l, alpha, lim, j * BK, cq,
                                       scale2);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive_if(free_v(sp), lane == 0);
        rescale<D>(acc, alpha);
        pack_p(pa, sc);
      };
      int j = 1;
      for (; j < min(nc, jm); ++j) step(j, std::false_type());
      for (; j < nc; ++j) step(j, std::true_type());
      const int s = (g + nc - 1) % NS;
      fence_regs(acc);
      fence_regs(pa);
      mbar_wait(bar_v(s), ((g + nc - 1) / NS) & 1);
      turn();
      wgmma_fence();
      mma_pv<D>(acc, pa, tile_k(s) + L::BYTES);
      pass();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_if(free_v(s), lane == 0);
    } else {
      mbar_arrive_if(free_q, lane == 0);
    }
    for (int i = phases(nc); i < phases(nkv); ++i) {
      turn();
      pass();
    }

    // ---- o = acc / l; a fully-masked row has l == 0 and gives 0 ---------
    __nv_bfloat16* ob = o + it.b * so.b + it.hq * so.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lt = lt == 0.f ? 1.f : lt;
      const int row = r + 8 * h;
      if (row < S) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          if (8 * i < DV)
            *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + 8 * i +
                                               cq) =
                __floats2bfloat162_rn(acc[4 * i + 2 * h] / lt,
                                      acc[4 * i + 2 * h + 1] / lt);
      }
    }
    // a tile this consumer skipped is released once it has arrived, so
    // that the release counts toward its own phase
    for (int j = nc; j < nkv; ++j) {
      const int s = (g + j) % NS, parity = ((g + j) / NS) & 1;
      mbar_wait(bar_k(s), parity);
      mbar_arrive_if(free_k(s), lane == 0);
      mbar_wait(bar_v(s), parity);
      mbar_arrive_if(free_v(s), lane == 0);
    }
    g += nkv;
  }
  if (c == 0) turn_wait(1);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime.
EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  if (!fn.load()) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn.store(reinterpret_cast<EncodeTiled>(p));
  }
  return fn.load();
}

// Code returned when a tensor map cannot be built: 10000 + the CUresult.
constexpr int MAP_ERROR = 10000;

// The (cols, rows, heads, batch) view of a bf16 tensor with element strides
// st = (batch, head, row), boxes of BOX x 128 x 1 x 1 of the D-wide tile
// (columns from cols to D are out of bounds: TMA reads them as zeros).
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int cols, int rows, int heads,
             int batch, const long long* st) {
  using L = Tile<D>;
  EncodeTiled encode = encode_tiled();
  if (!encode) return MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::BOX, 128, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, L::SWIZZLE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : MAP_ERROR + (int)res;
}

// next: one int, 0 at launch (the work counter). DV: the tensors' head dim
// (D, or less for the zero-filled route).
template <int D, int DV = D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Tn, const long long* st, float scale,
           int causal, int* next, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  int err = set_smem_once((const void*)attn_tc<D, DV>, Tile<D>::SMEM,
                          smem_set);
  if (err != (int)cudaSuccess) return err;
  const long long items = (long long)((S + BQ - 1) / BQ) * Hq * B;
  if (items == 0) return (int)cudaSuccess;
  if (items > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)))
    return err;
  CUtensorMap tq, tk, tv;
  if ((err = make_map<D>(&tq, q, DV, S, Hq, B, st)) ||
      (err = make_map<D>(&tk, k, DV, Tn, Hkv, B, st + 3)) ||
      (err = make_map<D>(&tv, v, DV, Tn, Hkv, B, st + 6)))
    return err;
  const Strides so{st[9], st[10], st[11]};
  // sections of the schedule: as many kv heads as L2_BYTES of K and V
  // hold, with all the q heads that read them
  const int group = Hq / Hkv;
  const long long heads = std::max(1ll, L2_BYTES / (4ll * Tn * D));
  const int sect = (int)std::min(heads * group, (long long)B * Hq);
  const int blocks = (int)std::min(items, (long long)sms);
  attn_tc<D, DV><<<blocks, NT, Tile<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so, B, Hq, group, S, Tn,
      scale * LOG2E, causal, sect, (int)items, next);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// o = attention(q, k, v) for q, k, v and o of one dtype (bf16 when is_bf16,
// else float32), D in {16, 32, 64, 112, 128}. strides: 12 element strides, the
// (batch, head, row) strides of q, k, v and o in that order; the d stride is
// 1. For bf16 the base addresses of q, k and v are 16-byte aligned and their
// strides multiples of 8 elements, and T > 0 (the tensor maps); next is one
// int in device memory, 0 at launch, the persistent kernel's work counter
// (float32 does not read it). Returns
// cudaGetLastError() after the launch, or the error of setting the kernel's
// shared-memory size, cudaErrorInvalidValue for a D it does not take, or
// 10000 + the CUresult of a tensor map that cannot be built.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int S, int T,
                               int D, const long long* strides, float scale,
                               int causal, int is_bf16, void* next,
                               void* stream) {
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* n = static_cast<int*>(next);
#define K2_ARGS q, k, v, o, B, Hq, Hkv, S, T, strides, scale, causal
  switch (is_bf16 ? D : -D) {
    case 16: return tc::launch<16>(K2_ARGS, n, s);
    case 32: return tc::launch<32>(K2_ARGS, n, s);
    case 64: return tc::launch<64>(K2_ARGS, n, s);
    case 112: return tc::launch<128, 112>(K2_ARGS, n, s);
    case 128: return tc::launch<128>(K2_ARGS, n, s);
    case -16: return fma::launch<16>(K2_ARGS, s);
    case -32: return fma::launch<32>(K2_ARGS, s);
    case -64: return fma::launch<64>(K2_ARGS, s);
    case -112: return fma::launch<112>(K2_ARGS, s);
    case -128: return fma::launch<128>(K2_ARGS, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2_ARGS
}

// Dynamic shared memory per block of each kernel, in bytes, as its launch
// asks for it: [is_bf16][i] for D = 16, 32, 64, 112, 128 (bf16 112 runs the
// D 128 tile).
extern "C" const int flash_attention_smem[2][5] = {
    {fma::smem_bytes<16>(), fma::smem_bytes<32>(), fma::smem_bytes<64>(),
     fma::smem_bytes<112>(), fma::smem_bytes<128>()},
    {tc::Tile<16>::SMEM, tc::Tile<32>::SMEM, tc::Tile<64>::SMEM,
     tc::Tile<128>::SMEM, tc::Tile<128>::SMEM}};
