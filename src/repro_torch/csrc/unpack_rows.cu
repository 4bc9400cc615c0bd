// The runner's copies on n virtual devices, each in one launch. The unpack:
// every device's copy of the payload out of the packet buffers, stacked,
// with the rows' padding and the relay rows dropped; and the in-place
// layout's pack (fill_inplace, below).
//
// Replaces no TPU kernel. The reference hands the shard_map's output to an
// XLA slice and reshape (src/repro/device/runner.py:136,
// out[:, :total].reshape(n, total * plen)[:, :x.size]). On one card the n
// devices' buffers are one [n, rows, row_bytes] byte tensor, and the copy
// out is
//
//   out[v, b] = buf[v, b / used, b % used]      v < n, b < nbytes
//
// into a fresh [n, nbytes] byte tensor. PyTorch's strided copy_ did it one
// byte an element at about 0.88 TB/s (PERF.md).
//
// Bound: bytes. It reads and writes n x nbytes bytes each: 65.5 GB for a
// 128e6 B payload on 256 devices, 19.6 ms at 3.35 TB/s. The rows of a
// device are used bytes long (8.9-60 KB on the benchmark's plans), mostly
// not a multiple of 16, so device v's output row r starts at
// v * nbytes + r * used, 4-byte aligned at best. The design:
//
// 1. One warp a segment. A segment is one packet row's share of the
//    output: row r < full = nbytes / used of device v gives used bytes,
//    row full gives the remainder rem = nbytes % used (if any). Warps take
//    segments in a grid-stride loop over all n x (full + (rem > 0)) of
//    them, device-major, so neighbouring warps stream neighbouring rows.
//    The grid is as many 256-thread blocks as the occupancy calculator
//    fits on the card. One 64-bit division an item finds (v, r); none per
//    byte.
// 2. 16-byte stores. The output is cut into aligned 16-byte chunks; the
//    segment that holds a chunk's first byte writes it. Every chunk that
//    lies inside its segment is one 16-byte store; it sits at a shift
//    sh = (-start) mod 16 from the row's 16-byte grid, the same for the
//    whole segment, so a warp takes one path an item:
//      sh == 0: one aligned 16-byte load (ld.global.nc) a chunk;
//      else:    the two aligned 16-byte chunks it straddles (the row is
//               16-byte aligned and a multiple of 16 long, so both lie in
//               it): a lane loads the first, and the second is the next
//               lane's first, passed by a warp shuffle (loading both in
//               every lane reached a lower share of the HBM peak on the
//               cells' rows, PERF.md section 6); their words
//               q = sh / 4 .. q + 4 chosen at compile time (q is a
//               template argument) and funnel-shifted right by
//               8 x (sh % 4) bits: a selection of words for every 4-byte
//               dtype, a byte shift for 1- and 2-byte ones.
//    A thread issues the loads of kUnroll chunks before their stores.
// 3. The chunk that runs past its segment's end (at most one a segment)
//    takes its bytes from the next segments: 16 lanes, a byte each, carry
//    the (device, row, column) forward from the segment, and each stores
//    its byte; past the tensor's end nothing is written.
//
// The runner's in-place layout (device/runner.py, unpack_tail) calls it
// for the tail alone: device v's one straddling row, out of the scratch
// rows after the output, into bytes [off, pitch) of device v's output, the
// output pitch bytes a device. Then every segment starts and ends on the
// 16-byte grid and step 3 never runs.
//
// The same library holds the in-place layout's pack (fill_inplace): one
// launch that starts a request's allocation as K1 needs it, in place of a
// zero fill and two copies, so that K1's launch follows the request's
// start by one launch of host work. In 16-byte chunks, grid-stride, the
// loads of kUnroll chunks before their stores: the root's payload into its
// output, and the scratch region after the n outputs zeroed but for the
// first tail bytes of the root's scratch, which take the payload's last
// tail bytes (its straddling row). Bound: bytes, nbytes read and nbytes +
// n x scratch written.
//
// Raw bytes: every dtype and every NaN payload comes through bit-exact.
// Byte offsets are 64-bit (the output is 32.8 GB at 128e6 B). Launches on
// the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // chunks a thread keeps in flight

struct Shape {
  long long dev_bytes;           // rows x row_bytes: one device's buffer
  long long row_bytes;
  long long used;                // payload bytes of a packet row
  long long full;                // nbytes / used: rows of used bytes
  long long rem;                 // nbytes % used: the last row's bytes
  long long segs;                // full + (rem > 0): segments a device
  long long nbytes;              // one device's output
  long long pitch;               // bytes from one device's output to the next
  long long off;                 // where a device's output starts in its pitch
  long long total;               // n x nbytes
};

__device__ __forceinline__ long long seg_len(const Shape& s, long long r) {
  return r < s.full ? s.used : s.rem;
}

// out chunks [0, count) from the aligned source chunks src[0, count)
__device__ __forceinline__ void copy_aligned(const uint4* __restrict__ src,
                                             uint4* dst, long long count,
                                             int lane) {
  for (long long base = lane; base < count; base += 32 * kUnroll) {
    uint4 val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 32 * u;
      if (i < count) val[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 32 * u;
      if (i < count) dst[i] = val[u];
    }
  }
}

// the 16 bytes at byte 4 * Q + shift / 8 of the 32 bytes a:b
template <int Q>
__device__ __forceinline__ uint4 window(const uint4& a, const uint4& b,
                                        unsigned shift) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], shift),
                    __funnelshift_r(w[Q + 1], w[Q + 2], shift),
                    __funnelshift_r(w[Q + 2], w[Q + 3], shift),
                    __funnelshift_r(w[Q + 3], w[Q + 4], shift));
}

// out chunk i from bytes 4 * Q + shift / 8 on of src[i] and src[i + 1]:
// lanes take neighbouring chunks, so a lane's src[i + 1] is the next lane's
// src[i], passed by a shuffle; lane 31 loads its own. src[count] is the
// last chunk's second, in the row, so the lane at i == count may load it.
template <int Q>
__device__ __forceinline__ void copy_shifted(const uint4* __restrict__ src,
                                             uint4* dst, long long count,
                                             unsigned shift, int lane) {
  for (long long base = 0; base < count; base += 32 * kUnroll) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 32 * u + lane;
      if (i <= count) a[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      b[u].x = __shfl_down_sync(0xffffffffu, a[u].x, 1);
      b[u].y = __shfl_down_sync(0xffffffffu, a[u].y, 1);
      b[u].z = __shfl_down_sync(0xffffffffu, a[u].z, 1);
      b[u].w = __shfl_down_sync(0xffffffffu, a[u].w, 1);
      const long long i = base + 32 * u + lane;
      if (lane == 31 && i < count) b[u] = __ldg(src + i + 1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 32 * u + lane;
      if (i < count) dst[i] = window<Q>(a[u], b[u], shift);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_rows_kernel(const uint8_t* __restrict__ buf, uint8_t* out, Shape s,
                   long long items) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       item < items; item += warps) {
    const long long v = item / s.segs, r = item - v * s.segs;
    const long long start = v * s.pitch + s.off + r * s.used;
    const long long len = seg_len(s, r);
    const long long end = start + len;
    const uint8_t* row = buf + v * s.dev_bytes + r * s.row_bytes;
    // chunks [k0, k1) lie inside the segment; chunk k1 is its too if it
    // starts in it and the segment does not end on the 16-byte grid
    const long long k0 = (start + 15) >> 4, k1 = end >> 4;
    const int sh = (int)(16 * k0 - start);    // k0's column, in [0, 16)
    const uint4* src = reinterpret_cast<const uint4*>(row);
    uint4* dst = reinterpret_cast<uint4*>(out) + k0;
    const long long count = k1 - k0;
    const unsigned shift = 8u * (sh & 3);
    switch (sh == 0 ? -1 : sh >> 2) {
      case -1: copy_aligned(src, dst, count, lane); break;
      case 0: copy_shifted<0>(src, dst, count, shift, lane); break;
      case 1: copy_shifted<1>(src, dst, count, shift, lane); break;
      case 2: copy_shifted<2>(src, dst, count, shift, lane); break;
      default: copy_shifted<3>(src, dst, count, shift, lane); break;
    }
    if ((end & 15) && k1 >= k0 && lane < 16) {
      const long long p = 16 * k1 + lane;
      if (p < s.total) {
        long long vv = v, rr = r, c = p - start, n = len;
        while (c >= n) {              // carry forward to p's segment
          c -= n;
          if (++rr == s.segs) rr = 0, ++vv;
          n = seg_len(s, rr);
        }
        out[p] = buf[vv * s.dev_bytes + rr * s.row_bytes + c];
      }
    }
  }
}

struct Fill {
  long long payload;             // chunks of the payload: nbytes / 16
  long long root_out;            // the root's output, in chunks
  long long scratch;             // the scratch region's start, in chunks
  long long tail_at;             // the root's straddling row in scratch
  long long tail;                // its chunks that take the payload's tail
  long long tail_src;            // the payload's tail, in chunks
  long long chunks;              // payload + n x scratch chunks a device
};

// chunk i of the fill: the payload's chunk i into the root's output, or
// scratch chunk i - payload, zero but for the root's straddling row
__device__ __forceinline__ void fill_chunk(const uint4* __restrict__ x,
                                           const Fill& f, long long i,
                                           long long* dst, uint4* val) {
  long long src = -1;
  if (i < f.payload) {
    *dst = f.root_out + i;
    src = i;
  } else {
    const long long j = i - f.payload, r = j - f.tail_at;
    *dst = f.scratch + j;
    if (r >= 0 && r < f.tail) src = f.tail_src + r;
  }
  *val = src >= 0 ? __ldg(x + src) : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads)
fill_inplace_kernel(const uint4* __restrict__ x, uint4* alloc, Fill f) {
  const long long threads = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x;
       base < f.chunks; base += threads * kUnroll) {
    long long dst[kUnroll];
    uint4 val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + threads * u;
      if (i < f.chunks) fill_chunk(x, f, i, dst + u, val + u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + threads * u < f.chunks) alloc[dst[u]] = val[u];
  }
}

// Blocks of kernel's grid on the current device: as many as the occupancy
// calculator fits, cached per device in cached; negative: a CUDA error,
// 0: the kernel does not fit an SM.
template <typename Kernel>
int grid_blocks(Kernel kernel, std::atomic<int>* cached) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 64 && cached[dev].load() > 0) return cached[dev].load();
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, 0)) != cudaSuccess)
    return -(int)err;
  const int blocks = per_sm * sms;
  if (dev < 64 && blocks > 0) cached[dev].store(blocks);
  return blocks;
}

std::atomic<int> unpack_blocks[64], fill_blocks[64];

}  // namespace

// buf: [n, rows, row_bytes] uint8, 16-byte aligned, row_bytes a multiple of
// 16; out: uint8, 16-byte aligned, on the same device, device v's nbytes at
// out + v * pitch + off; 0 < used <= row_bytes and nbytes <= rows * used.
// Either the output is [n, nbytes] (pitch = nbytes, off = 0) or used,
// nbytes, pitch and off are multiples of 16. Writes those bytes of out and
// no other in one launch on stream. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int unpack_rows(const void* buf, void* out, int n, long long rows,
                           long long row_bytes, long long used,
                           long long nbytes, long long pitch, long long off,
                           void* stream) {
  const int blocks = grid_blocks(unpack_rows_kernel, unpack_blocks);
  if (blocks < 0) return -blocks;
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  Shape s;
  s.dev_bytes = rows * row_bytes;
  s.row_bytes = row_bytes;
  s.used = used;
  s.full = nbytes / used;
  s.rem = nbytes % used;
  s.segs = s.full + (s.rem > 0);
  s.nbytes = nbytes;
  s.pitch = pitch;
  s.off = off;
  s.total = (long long)n * nbytes;
  const long long items = (long long)n * s.segs;
  const long long grid =
      std::min<long long>(blocks, (items + kWarps - 1) / kWarps);
  unpack_rows_kernel<<<(unsigned)grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<uint8_t*>(out), s, items);
  return (int)cudaGetLastError();
}

// x: the payload, nbytes uint8 bytes, 16-byte aligned; alloc: the in-place
// allocation, 16-byte aligned, on the same device: n outputs of nbytes,
// then n scratch regions of scratch bytes; tail < scratch bytes of the
// root's straddling row hold the payload's last tail bytes. nbytes, scratch
// and tail are multiples of 16. Writes the root's output and every scratch
// byte, and no other, in one launch on stream. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fill_inplace(const void* x, void* alloc, int n, int root,
                            long long nbytes, long long scratch,
                            long long tail, void* stream) {
  const int blocks = grid_blocks(fill_inplace_kernel, fill_blocks);
  if (blocks < 0) return -blocks;
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  Fill f;
  f.payload = nbytes / 16;
  f.root_out = (long long)root * f.payload;
  f.scratch = (long long)n * f.payload;
  f.tail_at = (long long)root * (scratch / 16);
  f.tail = tail / 16;
  f.tail_src = (nbytes - tail) / 16;
  f.chunks = f.payload + (long long)n * (scratch / 16);
  const long long need = (f.chunks + kThreads - 1) / kThreads;
  const long long grid = std::max<long long>(
      1, std::min<long long>(blocks, need));
  fill_inplace_kernel<<<(unsigned)grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(alloc), f);
  return (int)cudaGetLastError();
}
