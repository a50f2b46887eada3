// Kernel B2: the subscriber-bitmap OR of the big-filter fan-out, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel emqx_tpu/ops/bitmap.py::_or_kernel_dma
// (launched by or_bitmaps_dma) and honours the contract of its
// BlockSpec twin _or_kernel (or_bitmaps):
//
//     out[b, :] = OR over m of bitmaps[rows[b, m], :]   for rows[b, m] >= 0
//
// Bitmaps are int32[R, W] (the uint32 bits), rows int32[B, mb], out
// int32[B, W]; W is a multiple of 4 words. A row id at or past R has
// no bitmap and is skipped like -1 (rows_for_matches never makes one).
//
// Design: grid (W / (4 * kThreads), B); each thread owns one 16-byte
// word group (uint4) of topic b's output tile, loops over the mb row
// slots, ORs the matched rows' uint4 loads in registers and writes its
// group once. Neighbouring threads read neighbouring 16-byte groups, so
// every load and store is fully coalesced.
//
// What bounds it: memory traffic — the B x W output is written once
// and each matched row tile is read once per topic that matched it
// (L2 catches repeats of a hot row). TMA / cp.async pipelining and
// fusing rows_for_matches are later work.
//
// Built into one library with walk.cu, which exports the shared
// emqx_cuda_error(code) for both launchers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
bitmap_or_kernel(const uint4* __restrict__ bitmaps, const int* __restrict__ rows,
                 uint4* __restrict__ out, int mb, int W4, int R) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W4) return;
  const int* r = rows + static_cast<size_t>(b) * mb;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int m = 0; m < mb; ++m) {
    const int row = __ldg(r + m);
    if (row < 0 || row >= R) continue;
    const uint4 v = __ldg(bitmaps + static_cast<size_t>(row) * W4 + j);
    acc.x |= v.x;
    acc.y |= v.y;
    acc.z |= v.z;
    acc.w |= v.w;
  }
  out[static_cast<size_t>(b) * W4 + j] = acc;
}

}  // namespace

extern "C" int emqx_bitmap_or(const int* bitmaps, const int* rows, int* out,
                              int B, int mb, int W, int R, void* stream) {
  if (B < 0 || mb < 0 || W < 0 || (W & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || W == 0) return 0;
  const int W4 = W / 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const dim3 grid((W4 + kThreads - 1) / kThreads, nb);
    bitmap_or_kernel<<<grid, block, 0, st>>>(
        reinterpret_cast<const uint4*>(bitmaps), rows + static_cast<size_t>(b0) * mb,
        reinterpret_cast<uint4*>(out) + static_cast<size_t>(b0) * W4, mb, W4, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
