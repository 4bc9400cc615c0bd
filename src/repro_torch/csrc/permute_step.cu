// One BBS sub-round on n virtual devices: the collective-permute, the
// scatter and the gather of all n devices fused into one in-place launch.
//
// Replaces the TPU kernel src/repro/device/pallas_step.py:46
// (_scatter_gather_kernel): there each device ran its own call -- write the
// received row at r_idx if r_ok, read the row at s_idx zeroed unless s_ok --
// and a jax.lax.ppermute carried the read row to the next device. Here the
// n devices' packet buffers are one [n, rows, row_bytes] byte tensor, so the
// permute becomes an indexed row copy inside device memory. For every
// receiver v of the sub-round table tab = [src, s_ix, s_ok, r_ix, r_ok] x n:
//
//   val = (src[v] >= 0 && s_ok[src[v]]) ? buf[src[v], s_ix[src[v]]] : 0
//   if (r_ok[v]) buf[v, r_ix[v]] = val
//
// In place without a race because no device sends and receives the same
// row in one sub-round (checked when the schedule is compiled,
// repro_torch/device/schedule.py). Works on raw bytes, so any payload dtype
// (bf16, NaN payloads) comes through bit-exact.
//
// Bound: bytes moved. Per launch it reads one row and writes one row for
// every receiver that writes, 2 x receivers x row_bytes, with no arithmetic
// to speak of. The design is the plain one: grid.x over receivers, grid.y
// over 16-byte chunks of a row, one uint4 load and store per thread and
// step, neighbouring threads on neighbouring addresses. Byte offsets are
// 64-bit: a full-width buffer (256 devices x 772 rows x 21,744 B) is over
// 2^31 bytes. The kernel reads its own table slice, launches on the
// caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
permute_step_kernel(uint8_t* __restrict__ buf, const int32_t* __restrict__ tab,
                    int n, long long rows, long long row_bytes) {
  const int v = blockIdx.x;
  const int32_t* src = tab;
  const int32_t* s_ix = tab + n;
  const int32_t* s_ok = tab + 2 * n;
  const int32_t* r_ix = tab + 3 * n;
  const int32_t* r_ok = tab + 4 * n;
  if (r_ok[v] == 0) return;
  const int u = src[v];
  const bool ok = u >= 0 && s_ok[u] != 0;
  uint4* dst = reinterpret_cast<uint4*>(
      buf + ((long long)v * rows + r_ix[v]) * row_bytes);
  const uint4* from = ok ? reinterpret_cast<const uint4*>(
      buf + ((long long)u * rows + s_ix[u]) * row_bytes) : nullptr;
  const long long chunks = row_bytes / 16;
  const long long step = (long long)gridDim.y * kThreads;
  for (long long i = (long long)blockIdx.y * kThreads + threadIdx.x;
       i < chunks; i += step) {
    dst[i] = ok ? from[i] : make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

// buf: [n, rows, row_bytes] uint8, 16-byte aligned, row_bytes % 16 == 0;
// tab: int32 [5, n] on the same device. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int permute_step(void* buf, const void* tab, int n, long long rows,
                            long long row_bytes, void* stream) {
  const long long chunks = row_bytes / 16;
  long long gy = (chunks + kThreads - 1) / kThreads;
  if (gy > kMaxGridY) gy = kMaxGridY;
  dim3 grid((unsigned)n, (unsigned)gy);
  permute_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)buf, (const int32_t*)tab, n, rows, row_bytes);
  return (int)cudaGetLastError();
}
