// Kernel B3: the batched retained-name match of a subscribe burst, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// emqx_tpu/ops/retained_match.py::_retained_kernel (launched by
// match_names_many_pallas). It computes exactly what the plain twin
// emqx_tpu_torch/ops/retained_match.py::match_names_many computes: the
// [F, cap] hit matrix of F encoded filters against every stored name,
//
//     ok  = AND over l < min(fn[f], L) of (fw[f, l] == PLUS | fw[f, l] == ids[n, l])
//     hit = ok & (nw[n] == fn[f] | hh[f] & nw[n] >= fn[f]) & nw[n] > 0
//     out[f, n] = hit & !(sys[n] & (fw[f, 0] == PLUS | hh[f] & fn[f] == 0))
//
// fw int32[F, L] (PLUS -3, PAD -2, UNKNOWN -1), fn int32[F], hh and sys
// bytes 0/1 (torch.bool), ids int32[cap, L], nw int32[cap], out bytes
// 0/1 [F, cap]. L is 16 (RetainIndex.L).
//
// Design: the Pallas kernel tiles 8 filters x 512 names and so reads
// every name tile once per 8-filter block. Here each name is read once:
// one thread owns one name and keeps its word row, its length and its
// '$' flag in registers; the block stages the filters in shared memory,
// kChunk at a time, and every thread loops over them, writing
// out[f, name] as one byte. For each filter the 32 threads of a warp
// write 32 neighbouring bytes. The level loop stops at fn[f], which is
// the same for every thread of the block, so the exit is uniform and
// the unrolled word row stays in registers.
//
// Only the levels some filter compares are read: the block first takes
// the largest min(fn, L) of the burst, and each thread loads just the
// 16-byte quarters of its 64-byte row that cover those levels (one of
// four for filters of up to 4 levels). Ragged F and cap are masked here
// (threads past cap only help stage filters).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 16;          // levels of a stored name
constexpr int kPlus = -3;       // PLUS_ID: '+' in an encoded filter row
constexpr int kThreads = 256;   // names per block, one per thread
constexpr int kChunk = 128;     // filters staged in shared memory at once

__global__ void __launch_bounds__(kThreads)
retained_match_kernel(const int* __restrict__ fw, const int* __restrict__ fn,
                      const uint8_t* __restrict__ hh, const int4* __restrict__ ids,
                      const int* __restrict__ nw, const uint8_t* __restrict__ sys,
                      uint8_t* __restrict__ out, int F, int cap) {
  __shared__ int s_fw[kChunk * kL];
  __shared__ int s_fn[kChunk];
  __shared__ int s_hh[kChunk];
  __shared__ int s_levels;  // the most levels any filter compares

  if (threadIdx.x == 0) s_levels = 0;
  __syncthreads();
  int levels = 0;
  for (int i = threadIdx.x; i < F; i += kThreads) {
    levels = max(levels, min(__ldg(fn + i), kL));
  }
  if (levels > 0) atomicMax(&s_levels, levels);
  __syncthreads();
  const int quarters = (s_levels + 3) / 4;  // int4 loads a row needs

  const int name = blockIdx.x * kThreads + threadIdx.x;
  const bool mine = name < cap;
  int id[kL];
  int n = 0;
  bool is_sys = false;
  const int4* row = ids + static_cast<size_t>(mine ? name : 0) * (kL / 4);
#pragma unroll
  for (int q = 0; q < kL / 4; ++q) {
    // levels past every filter's count are never compared
    const int4 v = (mine && q < quarters) ? __ldg(row + q) : make_int4(0, 0, 0, 0);
    id[4 * q] = v.x;
    id[4 * q + 1] = v.y;
    id[4 * q + 2] = v.z;
    id[4 * q + 3] = v.w;
  }
  if (mine) {
    n = __ldg(nw + name);
    is_sys = __ldg(sys + name) != 0;
  }
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int nf = min(kChunk, F - f0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < nf * kL; i += kThreads) {
      s_fw[i] = __ldg(fw + static_cast<size_t>(f0) * kL + i);
    }
    for (int i = threadIdx.x; i < nf; i += kThreads) {
      s_fn[i] = __ldg(fn + f0 + i);
      s_hh[i] = __ldg(hh + f0 + i) != 0;
    }
    __syncthreads();
    if (!mine) continue;
    uint8_t* o = out + static_cast<size_t>(f0) * cap + name;
    for (int j = 0; j < nf; ++j) {
      const int fnj = s_fn[j];
      const int* w = s_fw + j * kL;
      bool ok = true;
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        if (l >= fnj) break;  // levels past fn are relaxed
        const int wl = w[l];
        ok &= (wl == kPlus) | (wl == id[l]);
      }
      const bool hash = s_hh[j] != 0;
      const bool hit = ok && n > 0 && (n == fnj || (hash && n >= fnj));
      const bool root_wild = w[0] == kPlus || (hash && fnj == 0);
      o[static_cast<size_t>(j) * cap] = (hit && !(is_sys && root_wild)) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int emqx_retained_match(const int* fw, const int* fn, const uint8_t* hh,
                                   const int* ids, const int* nw, const uint8_t* sys,
                                   uint8_t* out, int F, int cap, int L, void* stream) {
  if (F < 0 || cap < 0 || L != kL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0 || cap == 0) return 0;
  const int blocks = (cap + kThreads - 1) / kThreads;
  retained_match_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fw, fn, hh, reinterpret_cast<const int4*>(ids), nw, sys, out, F, cap);
  return static_cast<int>(cudaGetLastError());
}
