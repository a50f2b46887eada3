// Kernel B4: the dense subscriber-bitmap OR, for Hopper (sm_90a).
//
// Replaces the Pallas kernel emqx_tpu/ops/bitmap.py::_or_kernel (the
// BlockSpec OR launched by or_bitmaps). It also computes the device
// mesh's per-cell union (parallel/sharded.py::publish_step), which the
// JAX mesh runs through _or_kernel_dma over every topic:
//
//     out[b, :] = OR over m of bitmaps[rows[b, m], :]   for 0 <= rows[b, m] < R
//     out[b, :] = 0                                      where no slot is live
//
// bitmaps int32[R, W] (the uint32 bits), rows int32[B, mb], out
// int32[B, W]; W is a multiple of 4 words. A row id at or past R has no
// bitmap and is skipped like -1, as in bitmap_or.cu.
//
// What bounds it: bytes, and nearly all of them are the union's. At B4's
// shape (B = 4,096, W = 32,768, mb = 16, 8 distinct bitmap rows) the
// [B, W] union is 512 MiB written once against 1 MiB of bitmap rows and
// 256 KiB of row ids read once, so the floor is the HBM write rate. The
// packed kernel (bitmap_or.cu) run over every topic misses it by 3x:
// each output group re-reads every live row of its topic from L2 (about
// 14 bytes read for each byte written there), with one dependent pair
// of loads in flight a thread.
//
// Design: a block owns one strip of kThreads 16-byte groups (4 KiB of a
// row) for a chunk of kTopics consecutive topics; grid (strips, chunks).
//  1. The block reads the chunk's kTopics x mb row ids once and numbers
//     its first kStage distinct live rows in a table in shared memory,
//     which fills lock-free as a prefix: a thread scans it from slot 0
//     and claims the first empty slot with atomicCAS, so a row sits in
//     one slot only. Each topic gets a mask of the slots it reads; a row
//     the table has no slot for goes on the topic's spill list.
//  2. Each thread loads its own 16-byte column of every slot's row once,
//     into registers: a staged strip is read from L2 once a chunk, not
//     once a topic slot. No thread reads another's column, so nothing is
//     staged in shared memory.
//  3. For each topic of the chunk the thread ORs the staged columns its
//     mask selects (the mask is the same for the whole block: the
//     selects do not diverge), then its spilled rows straight from L2,
//     four loads in flight, and writes the group with a streaming store
//     (st.global.cs): the union is evicted first and the bitmap rows stay
//     in L2. A topic with no live slot reads nothing and writes zeros. OR
//     is idempotent and commutative, so duplicate row ids and the slots'
//     order change only the cost.
// What sets the pace is how many stores are in flight, so the kernel is
// kept small: 8 staged rows hold it at 64 registers, 4 blocks (32 warps)
// an SM, and 8-topic chunks keep the blocks short. On the card each of
// these streamed slower: 16 rows in registers (80-120 registers, 2-3
// blocks an SM); chunks of 4, 16, 32 or 64 topics; one persistent wave
// of blocks; and staging rows past the registers' in shared memory by
// cp.async, even where 64 distinct rows make most topics spill.
//
// Built into one library with walk.cu, which exports the shared
// emqx_cuda_error(code) for every launcher.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 16-byte groups a strip, one a thread
constexpr int kTopics = 8;        // topics a chunk
constexpr int kStage = 8;         // staged rows a chunk, in registers
constexpr int kSpillCap = 16;     // rows on a topic's spill list
constexpr unsigned kSpill = 1u << 31;  // the topic has spilled rows
constexpr int kEmpty = -1;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ void or_into(uint4& acc, const uint4& v) {
  acc.x |= v.x;
  acc.y |= v.y;
  acc.z |= v.z;
  acc.w |= v.w;
}

// The slot of row r in the prefix-filled table, claiming the first
// empty one; -1 when every slot holds another row.
__device__ __forceinline__ int claim(int* tab, int r) {
  volatile int* vt = tab;
  for (int k = 0; k < kStage; ++k) {
    int cur = vt[k];
    if (cur == kEmpty) cur = atomicCAS(tab + k, kEmpty, r);
    if (cur == kEmpty || cur == r) return k;
  }
  return -1;
}

// at most 64 registers: 4 blocks (32 warps) an SM
__global__ void __launch_bounds__(kThreads, 4)
bitmap_or_dense_kernel(const uint4* __restrict__ bitmaps,
                       const int* __restrict__ rows, uint4* __restrict__ out,
                       int c0, int B, int mb, int W4, int R) {
  __shared__ int tab[kStage];
  __shared__ unsigned mask[kTopics];
  __shared__ int n_spill[kTopics];
  __shared__ int spilled[kTopics][kSpillCap];
  const int tid = static_cast<int>(threadIdx.x);
  const int b0 = (c0 + static_cast<int>(blockIdx.y)) * kTopics;
  const int nt = B - b0 < kTopics ? B - b0 : kTopics;
  if (tid < kStage) tab[tid] = kEmpty;
  if (tid < kTopics) {
    mask[tid] = 0u;
    n_spill[tid] = 0;
  }
  __syncthreads();

  // 1. the chunk's row ids, read once: the table, masks and spill lists
  const int* chunk = rows + static_cast<size_t>(b0) * mb;
  const int slots = nt * mb;
  for (int i = tid; i < slots; i += kThreads) {
    const int r = __ldg(chunk + i);
    if (r < 0 || r >= R) continue;
    const int t = i / mb;
    const int k = claim(tab, r);
    if (k >= 0) {
      atomicOr(mask + t, 1u << k);
    } else {
      const int j = atomicAdd(n_spill + t, 1);
      if (j < kSpillCap) spilled[t][j] = r;
      atomicOr(mask + t, kSpill);
    }
  }
  __syncthreads();

  // 2. this thread's column of each staged row, once a chunk
  const int g = static_cast<int>(blockIdx.x) * kThreads + tid;
  if (g >= W4) return;
  uint4 v[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int r = tab[k];
    v[k] = r >= 0 ? __ldg(bitmaps + static_cast<size_t>(r) * W4 + g)
                  : make_uint4(0u, 0u, 0u, 0u);
  }

  // 3. compose each topic's group, stream it out
  uint4* o = out + static_cast<size_t>(b0) * W4 + g;
  for (int t = 0; t < nt; ++t, o += W4) {
    const unsigned m = mask[t];
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      if (m & (1u << k)) or_into(acc, v[k]);
    }
    if (m & kSpill) {
      // the rows past the table, from L2; a list that overflowed reads
      // the topic's every live row (staged ones again: OR is idempotent)
      const int n = n_spill[t];
      const bool listed = n <= kSpillCap;
      const int* r_t = listed ? spilled[t] : chunk + t * mb;
      const int len = listed ? n : mb;
      for (int j = 0; j < len; j += 4) {
        uint4 u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = j + q < len ? r_t[j + q] : -1;
          u[q] = r >= 0 && r < R
                     ? __ldg(bitmaps + static_cast<size_t>(r) * W4 + g)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) or_into(acc, u[q]);
      }
    }
    __stcs(o, acc);
  }
}

}  // namespace

extern "C" int emqx_bitmap_or_dense(const int* bitmaps, const int* rows,
                                    int* out, int B, int mb, int W, int R,
                                    void* stream) {
  if (B < 0 || mb < 0 || W < 0 || R < 0 || (W & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || W == 0) return 0;
  const int W4 = W / 4;
  const int chunks = (B + kTopics - 1) / kTopics;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < chunks; c0 += kMaxGridY) {
    const int nc = chunks - c0 < kMaxGridY ? chunks - c0 : kMaxGridY;
    const dim3 grid((W4 + kThreads - 1) / kThreads, nc);
    bitmap_or_dense_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const uint4*>(bitmaps), rows,
        reinterpret_cast<uint4*>(out), c0, B, mb, W4, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
