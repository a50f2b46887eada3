// Kernel B1: the NFA walk of a publish batch over the compressed trie
// automaton, for Hopper (sm_90a).
//
// Replaces the Pallas kernel emqx_tpu/ops/walk_pallas.py::_walk_kernel
// (launched by match_batch_pallas). It computes exactly what the plain
// walk emqx_tpu_torch/ops/match.py::match_batch computes: the raw emit
// slots emits[b, s, 0:k] ('#' terminals) and emits[b, s, k:2k] (end
// terminals) of every hop, and one overflow flag per topic. The
// pack_ids tail stays in torch (match.py::finish).
//
// Design: one warp per topic, WARPS topics per block. Lane i owns
// frontier slots i and i + 32 (k <= 64). The frontier and the 2k
// candidate lanes of a hop live in shared memory; each hop reads the
// live lanes' node2 rows and the two probed bucket rows straight from
// global memory (int4 loads), and only for lanes that need them.
//
// What bounds it: a dependent chain of small random reads per hop (one
// node2 row and two bucket rows per live lane); the data is tiny, so
// the bound is memory latency, and many warps in flight are what hide
// it. Making it fast (prefetching the next hop, caching hot rows in
// shared memory) is later work.
//
// Compaction order, as the plain walk defines it: for 2k <= 32
// candidates a descending sort (rank = number of strictly larger
// candidates, ties broken by position); for more, an order-preserving
// pack of concat[lit, plus] (ballot + popc prefix ranks). The main
// path reads the raw emit slots, so lane order is part of the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLvlBits = 5;
constexpr int kLvlMask = (1 << kLvlBits) - 1;
constexpr int kNarrowSlot = 4;   // [state, word, child, pad]
constexpr int kWideSlot = 16;    // [state, word, take, child, cw0..cw6, pad x5]
constexpr int kMaxK = 64;
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void hash_mix(uint32_t s, uint32_t w, uint32_t seed,
                                         uint32_t& h1, uint32_t& h2) {
  uint32_t h = s * 0x9E3779B9u + w * 0x85EBCA6Bu + seed;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  uint32_t g = h * 0x846CA68Bu;
  g ^= g >> 16;
  h1 = h;
  h2 = g;
}

// narrow bucket row: slots x [state, word, child, pad]
__device__ __forceinline__ int probe_narrow(const int* __restrict__ row,
                                            int slots, int state, int word) {
  int best = -1;
  for (int j = 0; j < slots; ++j) {
    const int4 e = __ldg(reinterpret_cast<const int4*>(row) + j);
    if (e.x == state && e.y == word) best = max(best, e.z);
  }
  return best;
}

// the topic's word at level l, -2 past the topic (the -2 padded window)
__device__ __forceinline__ int word_at(const int* __restrict__ words, int L,
                                       int l) {
  return l < L ? __ldg(words + l) : -2;
}

// wide bucket row: slots x [state, word, take, child, cw0..cw6, pad x5];
// exact inline chain-word verify, child and advance as maxima over hits
__device__ __forceinline__ void probe_wide(const int* __restrict__ row,
                                           int slots, int take, int state,
                                           int lvl, int n, int w0, int l0,
                                           const int* __restrict__ words,
                                           int L, int& child, int& adv) {
  for (int j = 0; j < slots; ++j) {
    const int4* e4 = reinterpret_cast<const int4*>(row + j * kWideSlot);
    const int4 h = __ldg(e4);
    if (h.x != state || h.y != w0) continue;
    const int stake = h.z;
    bool hit = lvl + stake <= n;
    if (hit && take > 1) {
      const int4 c0 = __ldg(e4 + 1);   // cw0..cw3
      const int4 c1 = __ldg(e4 + 2);   // cw4..cw6, pad
      const int cw[7] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z};
      for (int i = 0; i < take - 1 && i < 7; ++i) {
        if (stake > i + 1 && cw[i] != word_at(words, L, l0 + 1 + i)) {
          hit = false;
          break;
        }
      }
    }
    if (hit) {
      child = max(child, h.w);
      adv = max(adv, stake);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
walk_kernel(const int* __restrict__ word_ids, const int* __restrict__ n_words,
            const int* __restrict__ sys_mask, const int* __restrict__ seed_p,
            const int* __restrict__ wt, const int* __restrict__ node2,
            int* __restrict__ emits, int* __restrict__ ovf_out, int B, int L,
            int k, int steps, int slots, int take, int nb) {
  __shared__ int s_active[kWarps][kMaxK];
  __shared__ int s_cand[kWarps][2 * kMaxK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together
  int* active = s_active[warp];
  int* cand = s_cand[warp];

  const bool wide = take > 1;
  const int sw = wide ? kWideSlot : kNarrowSlot;
  const int rw = slots * sw;
  const uint32_t nbm = static_cast<uint32_t>(nb - 1);
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_p));
  const int n = __ldg(n_words + b);
  const bool is_sys = __ldg(sys_mask + b) != 0;
  const int* words = word_ids + static_cast<size_t>(b) * L;
  int* out = emits + static_cast<size_t>(b) * steps * 2 * k;
  const int nc = 2 * k;

  for (int i = lane; i < k; i += 32) active[i] = (i == 0) ? 0 : -1;
  __syncwarp();
  bool ovf = false;

  for (int s = 0; s < steps; ++s) {
    // phase 1: every frontier lane emits and proposes its successors
    for (int i = lane; i < k; i += 32) {
      const int a = active[i];
      int state, lvl;
      if (wide) {
        state = a >= 0 ? (a >> kLvlBits) : -1;
        lvl = a & kLvlMask;
      } else {
        state = a;
        lvl = s;
      }
      int emit_h = -1, emit_e = -1, lit = -1, plus = -1;
      if (state >= 0) {
        const int4 nd = __ldg(reinterpret_cast<const int4*>(node2) + state);
        const bool at_root_sys = wide ? (a == 0 && is_sys) : (s == 0 && is_sys);
        const bool walking = lvl < n;
        const bool ending = lvl == n;
        if ((walking || ending) && !at_root_sys) emit_h = nd.y;
        if (ending) emit_e = nd.z;
        if (walking) {
          const int l0 = min(lvl, L - 1);
          const int w0 = wide ? __ldg(words + l0) : word_at(words, L, s);
          if (w0 >= 0) {
            uint32_t h1, h2;
            hash_mix(static_cast<uint32_t>(state), static_cast<uint32_t>(w0),
                     seed, h1, h2);
            const int* r1 = wt + static_cast<size_t>(h1 & nbm) * rw;
            const int* r2 = wt + static_cast<size_t>(h2 & nbm) * rw;
            if (wide) {
              int child = -1, adv = 0;
              probe_wide(r1, slots, take, state, lvl, n, w0, l0, words, L,
                         child, adv);
              probe_wide(r2, slots, take, state, lvl, n, w0, l0, words, L,
                         child, adv);
              if (child >= 0) lit = (child << kLvlBits) | (lvl + adv);
            } else {
              lit = max(probe_narrow(r1, slots, state, w0),
                        probe_narrow(r2, slots, state, w0));
            }
          }
          if (!at_root_sys && nd.x >= 0)
            plus = wide ? ((nd.x << kLvlBits) | (lvl + 1)) : nd.x;
        }
      }
      out[s * nc + i] = emit_h;
      out[s * nc + k + i] = emit_e;
      cand[i] = lit;
      cand[k + i] = plus;
    }
    __syncwarp();
    // phase 2: compact the candidates into the next frontier
    if (nc <= 32) {
      const int v = lane < nc ? cand[lane] : -1;
      int rank = 0;
      for (int j = 0; j < nc; ++j) {
        const int c = cand[j];
        rank += (c > v) || (j < lane && c == v);
      }
      const int count = __popc(__ballot_sync(kFull, v >= 0));
      __syncwarp();
      for (int i = lane; i < k; i += 32) active[i] = -1;
      __syncwarp();
      if (v >= 0 && rank < k) active[rank] = v;
      ovf |= count > k;
    } else {
      for (int i = lane; i < k; i += 32) active[i] = -1;
      __syncwarp();
      int base = 0;
      for (int c0 = 0; c0 < nc; c0 += 32) {
        const int idx = c0 + lane;
        const int v = idx < nc ? cand[idx] : -1;
        const unsigned bal = __ballot_sync(kFull, v >= 0);
        const int r = base + __popc(bal & ((1u << lane) - 1u));
        if (v >= 0 && r < k) active[r] = v;
        base += __popc(bal);
      }
      ovf |= base > k;
    }
    __syncwarp();
  }
  // lanes alive after the last hop were never processed: their emits
  // are missing, so the topic goes to the exact host re-match
  bool res = false;
  for (int i = lane; i < k; i += 32) {
    const int a = active[i];
    if (a >= 0) res |= wide ? ((a & kLvlMask) <= n) : (steps <= n);
  }
  res = __any_sync(kFull, res);
  if (lane == 0) ovf_out[b] = (ovf || res) ? 1 : 0;
}

}  // namespace

extern "C" int emqx_walk(const int* word_ids, const int* n_words,
                         const int* sys_mask, const int* seed, const int* wt,
                         const int* node2, int* emits, int* ovf, int B, int L,
                         int k, int steps, int slots, int take, int nb,
                         void* stream) {
  if (k < 1 || k > kMaxK || B < 0 || L < 1 || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  walk_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      word_ids, n_words, sys_mask, seed, wt, node2, emits, ovf, B, L, k, steps,
      slots, take, nb);
  return static_cast<int>(cudaGetLastError());
}

// the error string of a launcher's return code (for every kernel of
// the library)
extern "C" const char* emqx_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
