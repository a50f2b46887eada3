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
// What bounds it: the function's bytes (each name's compared words,
// length and '$' flag read once, the F x cap bytes written once) set
// its least time, but a design with one name per thread is held by
// instruction issue instead: every shared-memory read of a filter
// word, every loop step and every one-byte store served one (filter,
// name) pair, about 80 lane instructions a pair. At the main path's
// shapes (1M names of 4 levels, F = 32-64) what is left is the integer
// pipe's work per pair plus the name reads, which do not overlap it.
//
// Design: each thread owns four consecutive names and keeps their word
// rows, lengths and '$' flags in registers, so every shared-memory
// read of a filter serves four names, and each filter's four results go
// out as one 32-bit store through a running pointer (a warp writes 128
// contiguous bytes per filter). The block stages the filters in shared
// memory, kChunk at a time, pre-digested: the words, each level's span
// (0 where the level is compared literally, below min(fn, L) and not
// '+'; ~0 elsewhere, which every word passes) and one int4 of the
// length range and the root-wildcard flag. Every test is then one
// unsigned range compare chained on a predicate: a word w' passes level
// l when w' - w[l] <= span[l], a length when nw - lo <= hi - lo with
// nw in [max(fn, 1), '#' ? INT_MAX : fn]; a '$' name's length reads as
// -1 (out of every range) when the filter is a root wildcard, and a
// dead filter's range is [INT_MIN, INT_MIN]. Against an XOR-and-mask
// form this moves the subtractions to the multiply-add pipe, off the
// integer pipe, and measured faster. The launch holds as many blocks
// as fit on the card at once, and each strides over groups of four
// names, so a block stages its filters once. Left on the table: a warp
// loads its names, then matches them, so loads and matching alternate
// instead of overlapping; loading the next group ahead, eight names a
// thread, branching per filter on its literal levels, and capping
// registers all measured slower.
//
// Only the levels some filter compares are read: the block first takes
// the largest min(fn, L) of the burst on the device, then switches,
// uniformly per block, to the instantiation that holds just the
// 16-byte quarters of a row that cover those levels (one of four for
// filters of up to 4 levels) in registers. When cap is not a multiple
// of 4, a filter's row of the output is not 4-byte aligned, and every
// block takes the byte-store path. Threads past the last name only help
// stage filters.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 16;          // levels of a stored name
constexpr int kQ = kL / 4;      // 16-byte quarters of a name row
constexpr int kPlus = -3;       // PLUS_ID: '+' in an encoded filter row
constexpr int kThreads = 256;
constexpr int kNames = 4;       // names per thread: one 32-bit store
constexpr int kChunk = 128;     // filters staged in shared memory at once

struct Staged {
  int4 w[kChunk * kQ];     // the filter's words
  int4 m[kChunk * kQ];     // each level's span: 0 if compared literally, else ~0
  int4 gate[kChunk];       // the length range (lo, span), root wildcard
};

// x in [lo, lo + span] as one unsigned compare
__device__ __forceinline__ bool within(int x, int lo, int span) {
  return static_cast<unsigned>(x) - static_cast<unsigned>(lo) <= static_cast<unsigned>(span);
}

__device__ __forceinline__ int level_span(int w, int level, int levels) {
  return (level < levels && w != kPlus) ? 0 : -1;
}

__device__ void stage(const int* __restrict__ fw, const int* __restrict__ fn,
                      const uint8_t* __restrict__ hh, int f0, int nf, Staged& s) {
  for (int i = threadIdx.x; i < nf; i += kThreads) {
    const int f = f0 + i;
    const int n = __ldg(fn + f);
    const bool hash = __ldg(hh + f) != 0;
    const int levels = min(n, kL);
    const int* w = fw + static_cast<size_t>(f) * kL;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int4 v = make_int4(__ldg(w + 4 * q), __ldg(w + 4 * q + 1),
                               __ldg(w + 4 * q + 2), __ldg(w + 4 * q + 3));
      s.w[i * kQ + q] = v;
      s.m[i * kQ + q] = make_int4(level_span(v.x, 4 * q, levels),
                                  level_span(v.y, 4 * q + 1, levels),
                                  level_span(v.z, 4 * q + 2, levels),
                                  level_span(v.w, 4 * q + 3, levels));
    }
    const int lo = max(n, 1);
    const int hi = hash ? INT_MAX : n;
    const bool root_wild = __ldg(w) == kPlus || (hash && n == 0);
    // a dead filter's range [INT_MIN, INT_MIN] holds no length
    s.gate[i] = hi < lo ? make_int4(INT_MIN, 0, root_wild, 0)
                        : make_int4(lo, hi - lo, root_wild, 0);
  }
}

// Q: the 16-byte quarters of a name row that some filter compares.
// The block stages a chunk of filters once, then strides over groups of
// four names, so the staging and the block's start are paid once per
// block, not once per 1,024 names.
template <int Q>
__device__ __forceinline__ void match_names(
    const int* __restrict__ fw, const int* __restrict__ fn,
    const uint8_t* __restrict__ hh, const int4* __restrict__ ids,
    const int* __restrict__ nw, const uint8_t* __restrict__ sys,
    uint8_t* __restrict__ out, int F, int cap, Staged& s) {
  const int groups = (cap + kNames - 1) / kNames;
  const bool word_stores = (cap & 3) == 0;  // uniform over the grid
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int nf = min(kChunk, F - f0);
    __syncthreads();  // every thread is done with the previous chunk
    stage(fw, fn, hh, f0, nf, s);
    __syncthreads();
    for (int grp = blockIdx.x * kThreads + threadIdx.x; grp < groups;
         grp += gridDim.x * kThreads) {
      const int name0 = grp * kNames;
      int id[kNames][4 * Q];
      int len[kNames];       // nw
      unsigned sysbits = 0;  // bit k: name k starts with '$'
#pragma unroll
      for (int k = 0; k < kNames; ++k) {
        const int name = name0 + k;
        const bool live = name < cap;
        const int4* row = ids + static_cast<size_t>(live ? name : 0) * kQ;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int4 v = live ? __ldg(row + q) : make_int4(0, 0, 0, 0);
          id[k][4 * q] = v.x;
          id[k][4 * q + 1] = v.y;
          id[k][4 * q + 2] = v.z;
          id[k][4 * q + 3] = v.w;
        }
        len[k] = live ? __ldg(nw + name) : 0;
        sysbits |= (live && __ldg(sys + name) != 0) ? 1u << k : 0u;
      }
      uint8_t* dst = out + static_cast<size_t>(f0) * cap + name0;
      for (int j = 0; j < nf; ++j, dst += cap) {
        const int4 g = s.gate[j];
        // under a root wildcard a '$' name's length reads as -1, outside
        // every range
        const unsigned sys_out = g.z ? sysbits : 0u;
        bool ok[kNames];
#pragma unroll
        for (int k = 0; k < kNames; ++k) {
          ok[k] = within((sys_out >> k) & 1u ? -1 : len[k], g.x, g.y);
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int4 w = s.w[j * kQ + q];
          const int4 m = s.m[j * kQ + q];
#pragma unroll
          for (int k = 0; k < kNames; ++k) {
            ok[k] = ok[k] && within(id[k][4 * q], w.x, m.x) &&
                    within(id[k][4 * q + 1], w.y, m.y) &&
                    within(id[k][4 * q + 2], w.z, m.z) && within(id[k][4 * q + 3], w.w, m.w);
          }
        }
        unsigned hits = 0;
#pragma unroll
        for (int k = 0; k < kNames; ++k) hits |= ok[k] ? 1u << (8 * k) : 0u;
        if (word_stores) {
          *reinterpret_cast<unsigned*>(dst) = hits;
        } else {
#pragma unroll
          for (int k = 0; k < kNames; ++k) {
            if (name0 + k < cap) dst[k] = static_cast<uint8_t>(hits >> (8 * k));
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
retained_match_kernel(const int* __restrict__ fw, const int* __restrict__ fn,
                      const uint8_t* __restrict__ hh, const int4* __restrict__ ids,
                      const int* __restrict__ nw, const uint8_t* __restrict__ sys,
                      uint8_t* __restrict__ out, int F, int cap) {
  __shared__ Staged s;
  __shared__ int s_levels;  // the most levels any filter compares

  if (threadIdx.x == 0) s_levels = 0;
  __syncthreads();
  int levels = 0;
  for (int i = threadIdx.x; i < F; i += kThreads) {
    levels = max(levels, min(__ldg(fn + i), kL));
  }
  if (levels > 0) atomicMax(&s_levels, levels);
  __syncthreads();
  switch ((s_levels + 3) / 4) {  // the same in every thread of the block
    case 0:
    case 1: match_names<1>(fw, fn, hh, ids, nw, sys, out, F, cap, s); break;
    case 2: match_names<2>(fw, fn, hh, ids, nw, sys, out, F, cap, s); break;
    case 3: match_names<3>(fw, fn, hh, ids, nw, sys, out, F, cap, s); break;
    default: match_names<4>(fw, fn, hh, ids, nw, sys, out, F, cap, s); break;
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
  // as many blocks as fit on the card at once, fewer for a small index
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, retained_match_kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kThreads * kNames;
  const int need = (cap + per_block - 1) / per_block;
  const int blocks = need < sms * per_sm ? need : sms * per_sm;
  retained_match_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fw, fn, hh, reinterpret_cast<const int4*>(ids), nw, sys, out, F, cap);
  return static_cast<int>(cudaGetLastError());
}
