// Kernel B2: the subscriber-bitmap OR of the big-filter fan-out, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel emqx_tpu/ops/bitmap.py::_or_kernel_dma
// (launched by or_bitmaps_dma) and, with a null src, honours the
// contract of its BlockSpec twin _or_kernel (or_bitmaps, kernel B4):
// one kernel serves both.
//
//     b      = src ? src[p] : p                       for p < P
//     out[p] = OR over m of bitmaps[rows[b, m], :]    for rows[b, m] >= 0
//     out[p] = 0                                      where b < 0
//
// Bitmaps are int32[R, W] (the uint32 bits), rows int32[B, mb], src
// int32[P] or null (then P = B: the dense [B, W] union), out
// int32[P, W]; W is a multiple of 4 words. A row id at or past R has
// no bitmap and is skipped like -1 (rows_for_matches never makes one).
//
// The publish path packs the union: src is the slot map of the
// topics that matched a big filter (union_slots), P the packed-row
// budget (8 by default), so the kernel writes the P packed rows the
// fetch copies and nothing else. The dense route it replaces wrote a
// [B, W] union (4,096 x 32,768 words, 512 MiB a batch) and then
// gathered P rows of it. The packed function's bound is its bytes:
// P * mb + P row ids and the distinct live bitmap rows read once, the
// P x W words written once — about 1-2 MiB on the main path, under a
// microsecond at 3.35 TB/s, so one launch's latency is its floor. The
// design therefore aims at exactly one launch and no dense buffer,
// not at TMA pipelining.
//
// Grid (W / (4 * kThreads * kUnroll), P): one strip of blocks per
// output row. A block reads its own src[p]; a dead slot (b < 0)
// writes zeros and reads nothing. Otherwise each thread keeps kUnroll
// independent 16-byte (uint4) loads of each live row in flight, ORs
// them in registers and writes its groups once; neighbouring threads
// read and write neighbouring 16-byte groups, so every access is
// coalesced and the few live rows stream through L2 at full width.
//
// Built into one library with walk.cu, which exports the shared
// emqx_cuda_error(code) for every launcher.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // uint4 loads in flight per thread and row
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
bitmap_or_kernel(const uint4* __restrict__ bitmaps, const int* __restrict__ rows,
                 const int* __restrict__ src, uint4* __restrict__ out, int p0,
                 int B, int mb, int W4, int R) {
  const int p = p0 + static_cast<int>(blockIdx.y);
  const int b = src != nullptr ? __ldg(src + p) : p;
  const int j0 = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  uint4 acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = make_uint4(0u, 0u, 0u, 0u);
  if (b >= 0 && b < B) {
    const int* r = rows + static_cast<size_t>(b) * mb;
    for (int m = 0; m < mb; ++m) {
      const int row = __ldg(r + m);
      if (row < 0 || row >= R) continue;
      const uint4* base = bitmaps + static_cast<size_t>(row) * W4;
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        v[u] = j < W4 ? __ldg(base + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc[u].x |= v[u].x;
        acc[u].y |= v[u].y;
        acc[u].z |= v[u].z;
        acc[u].w |= v[u].w;
      }
    }
  }
  uint4* o = out + static_cast<size_t>(p) * W4;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * kThreads;
    if (j < W4) o[j] = acc[u];
  }
}

}  // namespace

extern "C" int emqx_bitmap_or(const int* bitmaps, const int* rows, const int* src,
                              int* out, int P, int B, int mb, int W, int R,
                              void* stream) {
  if (P < 0 || B < 0 || mb < 0 || W < 0 || (W & 3) != 0 ||
      (src == nullptr && P != B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0 || W == 0) return 0;
  const int W4 = W / 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const int strip = kThreads * kUnroll;
  for (int p0 = 0; p0 < P; p0 += kMaxGridY) {
    const int np = P - p0 < kMaxGridY ? P - p0 : kMaxGridY;
    const dim3 grid((W4 + strip - 1) / strip, np);
    bitmap_or_kernel<<<grid, block, 0, st>>>(
        reinterpret_cast<const uint4*>(bitmaps), rows, src,
        reinterpret_cast<uint4*>(out), p0, B, mb, W4, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
