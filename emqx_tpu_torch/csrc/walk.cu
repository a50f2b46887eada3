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
// What bounds it: a dependent chain of `steps` device-memory round
// trips per topic, not bytes. A hop's reads (the live states' node2
// rows and two bucket rows each) hang on the previous hop's
// compaction, the walk tables of a large automaton do not fit the L2,
// and a batch of topics is one wave of warps, so the kernel takes about
// one warp's chain: `steps` miss latencies.
//
// What the design does about it: one warp walks one topic, and a hop
// costs one round trip. Every lane issues all of its loads of the hop
// (its state's node2 row and the kSlots entries of both bucket rows,
// the wide entries' chain words with their heads) before it compares
// any of them; the slot count is a template parameter, so the probes
// are unrolled. The topic's words are loaded once, before the first
// hop, into registers (lane l holds words l and l + 32) and reach a hop
// by __shfl_sync. The frontier stays in registers (lane i holds slots
// i and i + 32) and is compacted with shuffles and ballots; nothing
// passes through shared memory. At k <= 16 lanes 16-31 probe the
// second bucket row of lanes 0-15, and one shuffle merges the two
// halves. In the wide layout a lane's hop loads 24 entry parts (12 with
// split rows), and ptxas reads some of them before it has issued the
// last, so a wide hop can take more than one round trip.
//
// Past one warp's registers (k > 64, or a topic of more than 64
// levels) the walk takes walk_kernel_gmem: the same hop and the same
// compaction orders, with the frontier and the hop's candidates in a
// scratch row of 3k ints a topic in device memory (the wrapper
// allocates it), the frontier probed 32 slots at a time, and each
// word read from the topic's row in device memory. Neither limit is on
// the main path (k = 16, 5 levels); the register kernel stays its
// instantiation.
//
// Compaction order, as the plain walk defines it: for 2k <= 32
// candidates a descending sort (rank = number of strictly larger
// candidates, ties broken by position); for more, an order-preserving
// pack of concat[lit, plus]. The main path reads the raw emit slots,
// so lane order is part of the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLvlBits = 5;
constexpr int kLvlMask = (1 << kLvlBits) - 1;
constexpr int kNarrowSlot = 4;   // [state, word, child, pad]
constexpr int kWideSlot = 16;    // [state, word, take, child, cw0..cw6, pad x5]
constexpr int kNarrowSlots = 2;  // entries in a narrow bucket row
constexpr int kWideSlots = 4;    // entries in a wide bucket row
constexpr int kMaxK = 64;         // the register kernel's frontier
constexpr int kMaxL = 64;         // the register kernel's words
constexpr int kMaxTake = 8;      // 1 key word + 7 inline chain words
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

// the topic's word at level x, -2 past the topic (the -2 padded
// window); lane l holds words l (lo) and l + 32 (hi). Every lane calls.
__device__ __forceinline__ int word_at(int lo, int hi, int L, int x) {
  const int a = __shfl_sync(kFull, lo, x & 31);
  const int b = L > 32 ? __shfl_sync(kFull, hi, x & 31) : -2;
  return x < L ? (x < 32 ? a : b) : -2;
}

// position of the n-th set bit of m (n < popc(m))
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int p = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      p += w;
    }
  }
  return p;
}

// One hop's reads of one frontier slot: the node2 row and the bucket
// entries (kSlots of each row it probes; wide entries as head, cw0..3,
// cw4..6). Filled first, read by the compares after every load of the
// hop is in flight.
template <bool WIDE, int NROWS>
struct HopReads {
  static constexpr int kSlots = WIDE ? kWideSlots : kNarrowSlots;
  int4 nd;
  int4 e[NROWS][kSlots][3];   // narrow entries use part 0 only
};

__device__ __forceinline__ int4 ldg4(const int4* p, bool on) {
  return on ? __ldg(p) : make_int4(-1, -1, -1, -1);
}

// the bucket entries' loads, all issued before any is read
template <bool WIDE, int NROWS>
__device__ __forceinline__ void issue(HopReads<WIDE, NROWS>& r,
                                      const int4* const (&rows)[NROWS],
                                      bool probe, int take) {
  using R = HopReads<WIDE, NROWS>;
#pragma unroll
  for (int q = 0; q < NROWS; ++q) {
#pragma unroll
    for (int t = 0; t < R::kSlots; ++t) {
      if constexpr (WIDE) {
        const int4* e4 = rows[q] + t * (kWideSlot / 4);
        r.e[q][t][0] = ldg4(e4, probe);
        r.e[q][t][1] = ldg4(e4 + 1, probe);               // cw0..cw3
        r.e[q][t][2] = ldg4(e4 + 2, probe && take > 5);   // cw4..cw6
      } else {
        r.e[q][t][0] = ldg4(rows[q] + t, probe);
      }
    }
  }
}

// narrow compare: the largest child of an entry keyed (state, word)
template <int NROWS>
__device__ __forceinline__ int probe_narrow(const HopReads<false, NROWS>& r,
                                            int state, int w0) {
  int best = -1;
#pragma unroll
  for (int q = 0; q < NROWS; ++q) {
#pragma unroll
    for (int t = 0; t < kNarrowSlots; ++t) {
      const int4 e = r.e[q][t][0];
      if (e.x == state && e.y == w0) best = max(best, e.z);
    }
  }
  return best;
}

// wide compare: exact inline chain-word verify; child and advance as
// maxima over the hits
template <int NROWS>
__device__ __forceinline__ void probe_wide(const HopReads<true, NROWS>& r,
                                           int state, int lvl, int n, int w0,
                                           const int (&cw)[kMaxTake - 1],
                                           int take, int& child, int& adv) {
#pragma unroll
  for (int q = 0; q < NROWS; ++q) {
#pragma unroll
    for (int t = 0; t < kWideSlots; ++t) {
      const int4 h = r.e[q][t][0];
      const int4 c0 = r.e[q][t][1];
      const int4 c1 = r.e[q][t][2];
      const int ew[kMaxTake - 1] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z};
      const int stake = h.z;
      bool hit = h.x == state && h.y == w0 && lvl + stake <= n;
#pragma unroll
      for (int i = 0; i < kMaxTake - 1; ++i) {
        if (i < take - 1 && stake > i + 1 && ew[i] != cw[i]) hit = false;
      }
      if (hit) {
        child = max(child, h.w);
        adv = max(adv, stake);
      }
    }
  }
}

// PER frontier slots per lane (k <= 32: 1, else 2); SPLIT (k <= 16):
// lanes q and q + 16 hold frontier slot q, the low one probing the
// first bucket row, the high one the second. The launch bound's
// minimum of one block an SM frees ptxas from its occupancy target:
// with it every narrow instantiation issues all of a hop's loads
// before it reads one (machine code read on an H100); without it the
// k > 16 ones read the first entries before issuing the last load.
template <bool WIDE, int PER, bool SPLIT>
__global__ void __launch_bounds__(kWarps * 32, 1)
walk_kernel(const int* __restrict__ word_ids, const int* __restrict__ n_words,
            const int* __restrict__ sys_mask, const int* __restrict__ seed_p,
            const int* __restrict__ wt, const int* __restrict__ node2,
            int* __restrict__ emits, int* __restrict__ ovf_out, int B, int L,
            int k, int steps, int take, int nb) {
  static_assert(!SPLIT || PER == 1, "split rows need k <= 16");
  constexpr int kSlots = WIDE ? kWideSlots : kNarrowSlots;
  constexpr int kRow4 = kSlots * (WIDE ? kWideSlot : kNarrowSlot) / 4;
  constexpr int kRows = SPLIT ? 1 : 2;   // bucket rows a lane probes
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together
  const bool hi_half = SPLIT && lane >= 16;
  const int slot0 = SPLIT ? (lane & 15) : lane;   // frontier slot of act[0]

  // the topic's inputs, read once: one round trip before the first hop
  const uint32_t nbm = static_cast<uint32_t>(nb - 1);
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_p));
  const int n = __ldg(n_words + b);
  const bool is_sys = __ldg(sys_mask + b) != 0;
  const int* words = word_ids + static_cast<size_t>(b) * L;
  const int wlo = lane < L ? __ldg(words + lane) : -2;
  const int whi = lane + 32 < L ? __ldg(words + lane + 32) : -2;
  const int4* n2 = reinterpret_cast<const int4*>(node2);
  const int4* w4 = reinterpret_cast<const int4*>(wt);
  int* out = emits + static_cast<size_t>(b) * steps * 2 * k;
  const int nc = 2 * k;

  int act[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) act[j] = (j == 0 && slot0 == 0) ? 0 : -1;
  bool ovf = false;

  for (int s = 0; s < steps; ++s) {
    const int ws = WIDE ? 0 : word_at(wlo, whi, L, s);
    int state[PER], lvl[PER], w0[PER];
    int cw[PER][kMaxTake - 1];
    bool probe[PER];
    HopReads<WIDE, kRows> rd[PER];
    // issue every load of the hop before any compare: the node2 rows
    // (their address is known at the hop's start), then the buckets
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int a = act[j];
      state[j] = WIDE ? (a >= 0 ? (a >> kLvlBits) : -1) : a;
      lvl[j] = WIDE ? (a & kLvlMask) : s;
      rd[j].nd = ldg4(n2 + max(state[j], 0), state[j] >= 0 && !hi_half);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int l0 = min(lvl[j], L - 1);
      w0[j] = WIDE ? word_at(wlo, whi, L, l0) : ws;
#pragma unroll
      for (int i = 0; i < kMaxTake - 1; ++i)
        cw[j][i] = (WIDE && i < take - 1) ? word_at(wlo, whi, L, l0 + 1 + i)
                                          : -2;
      probe[j] = state[j] >= 0 && lvl[j] < n && w0[j] >= 0;
      uint32_t h1, h2;
      hash_mix(static_cast<uint32_t>(state[j]), static_cast<uint32_t>(w0[j]),
               seed, h1, h2);
      const int4* rows[kRows];
      if (SPLIT) {
        rows[0] = w4 + static_cast<size_t>((hi_half ? h2 : h1) & nbm) * kRow4;
      } else {
        rows[0] = w4 + static_cast<size_t>(h1 & nbm) * kRow4;
        rows[kRows - 1] = w4 + static_cast<size_t>(h2 & nbm) * kRow4;
      }
      issue<WIDE, kRows>(rd[j], rows, probe[j], take);
    }
    // compare, emit, propose
    int lit[PER], plus[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = 32 * j + slot0;
      const int4 nd = rd[j].nd;
      const bool live = state[j] >= 0;
      const bool walking = live && lvl[j] < n;
      const bool ending = live && lvl[j] == n;
      const bool at_root_sys =
          is_sys && (WIDE ? act[j] == 0 : s == 0);
      if constexpr (WIDE) {
        int child = -1, adv = 0;
        probe_wide<kRows>(rd[j], state[j], lvl[j], n, w0[j], cw[j], take,
                          child, adv);
        if (SPLIT) {
          child = max(child, __shfl_xor_sync(kFull, child, 16));
          adv = max(adv, __shfl_xor_sync(kFull, adv, 16));
        }
        lit[j] = probe[j] && child >= 0 ? (child << kLvlBits) | (lvl[j] + adv)
                                        : -1;
      } else {
        int best = probe_narrow<kRows>(rd[j], state[j], w0[j]);
        if (SPLIT) best = max(best, __shfl_xor_sync(kFull, best, 16));
        lit[j] = probe[j] ? best : -1;
      }
      plus[j] = walking && !at_root_sys && nd.x >= 0
                    ? (WIDE ? ((nd.x << kLvlBits) | (lvl[j] + 1)) : nd.x)
                    : -1;
      if (i < k && !hi_half) {
        out[s * nc + i] = (walking || ending) && !at_root_sys ? nd.y : -1;
        out[s * nc + k + i] = ending ? nd.z : -1;
      }
    }
    // compact the candidates into the next frontier, in registers
    if (nc <= 32) {
      // candidate p on lane p: lit of slot p, then plus of slot p - k
      const int pp = __shfl_sync(kFull, plus[0], lane >= k ? lane - k : lane);
      const int v = lane < k ? lit[0] : (lane < nc ? pp : -1);
      const unsigned vm = __ballot_sync(kFull, v >= 0);
      int rank = 0;
      for (unsigned m = vm; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int c = __shfl_sync(kFull, v, src);
        rank += (c > v) || (c == v && src < lane);
      }
      int nxt = -1;
      for (unsigned m = vm; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int r = __shfl_sync(kFull, rank, src);
        const int c = __shfl_sync(kFull, v, src);
        if (r == slot0) nxt = c;
      }
      act[0] = slot0 < k ? nxt : -1;
#pragma unroll
      for (int j = 1; j < PER; ++j) act[j] = -1;
      ovf |= __popc(vm) > k;
    } else {
      // positions in order: lit of slots 0..k-1, plus of slots 0..k-1;
      // slot 32j + lane is lit[j] / plus[j] on that lane
      unsigned mk[2 * PER];
      int base[2 * PER + 1];
      base[0] = 0;
#pragma unroll
      for (int g = 0; g < 2 * PER; ++g) {
        const int c = g < PER ? lit[g] : plus[g - PER];
        mk[g] = __ballot_sync(kFull, c >= 0);
        base[g + 1] = base[g] + __popc(mk[g]);
      }
      const int total = base[2 * PER];
#pragma unroll
      for (int jd = 0; jd < PER; ++jd) {
        const int d = 32 * jd + lane;
        int g = 0;
#pragma unroll
        for (int gg = 1; gg < 2 * PER; ++gg) g += d >= base[gg];
        unsigned m = mk[0];
        int nb0 = base[0];
#pragma unroll
        for (int gg = 1; gg < 2 * PER; ++gg) {
          if (g == gg) {
            m = mk[gg];
            nb0 = base[gg];
          }
        }
        const int src = nth_bit(m, d - nb0);
        int val = -1;
#pragma unroll
        for (int gg = 0; gg < 2 * PER; ++gg) {
          const int c = __shfl_sync(
              kFull, gg < PER ? lit[gg] : plus[gg - PER], src);
          if (g == gg) val = c;
        }
        act[jd] = d < k && d < total ? val : -1;
      }
      ovf |= total > k;
    }
  }
  // lanes alive after the last hop were never processed: their emits
  // are missing, so the topic goes to the exact host re-match
  bool res = false;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int a = act[j];
    if (a >= 0) res |= WIDE ? ((a & kLvlMask) <= n) : (steps <= n);
  }
  res = __any_sync(kFull, res);
  if (lane == 0) ovf_out[b] = (ovf || res) ? 1 : 0;
}


// the topic's word at level x from device memory (-2 past the topic)
__device__ __forceinline__ int word_g(const int* words, int L, int x) {
  return x < L ? __ldg(words + x) : -2;
}

// Any k and any L (module note above): frontier act[k] and candidates
// cand[2k] (lit of slots 0..k-1, then plus) in the topic's scratch row.
// A lane handles frontier slots lane, lane + 32, ...; __syncwarp orders
// the warp's scratch writes before its reads.
template <bool WIDE>
__global__ void __launch_bounds__(kWarps * 32)
walk_kernel_gmem(const int* __restrict__ word_ids,
                 const int* __restrict__ n_words,
                 const int* __restrict__ sys_mask,
                 const int* __restrict__ seed_p, const int* __restrict__ wt,
                 const int* __restrict__ node2, int* __restrict__ emits,
                 int* __restrict__ ovf_out, int* __restrict__ scratch, int B,
                 int L, int k, int steps, int take, int nb) {
  constexpr int kSlots = WIDE ? kWideSlots : kNarrowSlots;
  constexpr int kRow4 = kSlots * (WIDE ? kWideSlot : kNarrowSlot) / 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together
  const uint32_t nbm = static_cast<uint32_t>(nb - 1);
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_p));
  const int n = __ldg(n_words + b);
  const bool is_sys = __ldg(sys_mask + b) != 0;
  const int* words = word_ids + static_cast<size_t>(b) * L;
  const int4* n2 = reinterpret_cast<const int4*>(node2);
  const int4* w4 = reinterpret_cast<const int4*>(wt);
  const int nc = 2 * k;
  int* out = emits + static_cast<size_t>(b) * steps * nc;
  int* act = scratch + static_cast<size_t>(b) * 3 * k;
  int* cand = act + k;
  for (int i = lane; i < k; i += 32) act[i] = i == 0 ? 0 : -1;
  __syncwarp();
  bool ovf = false;

  for (int s = 0; s < steps; ++s) {
    const int ws = WIDE ? 0 : word_g(words, L, s);
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int i = c0 + lane;
      const int a = i < k ? act[i] : -1;
      const int state = WIDE ? (a >= 0 ? (a >> kLvlBits) : -1) : a;
      const int lvl = WIDE ? (a & kLvlMask) : s;
      HopReads<WIDE, 2> rd;
      rd.nd = ldg4(n2 + max(state, 0), state >= 0);
      const int l0 = min(lvl, L - 1);
      const int w0 = WIDE ? word_g(words, L, l0) : ws;
      int cw[kMaxTake - 1];
#pragma unroll
      for (int t = 0; t < kMaxTake - 1; ++t)
        cw[t] = (WIDE && t < take - 1) ? word_g(words, L, l0 + 1 + t) : -2;
      const bool probe = state >= 0 && lvl < n && w0 >= 0;
      uint32_t h1, h2;
      hash_mix(static_cast<uint32_t>(state), static_cast<uint32_t>(w0), seed,
               h1, h2);
      const int4* rows[2] = {w4 + static_cast<size_t>(h1 & nbm) * kRow4,
                             w4 + static_cast<size_t>(h2 & nbm) * kRow4};
      issue<WIDE, 2>(rd, rows, probe, take);
      const int4 nd = rd.nd;
      const bool live = state >= 0;
      const bool walking = live && lvl < n;
      const bool ending = live && lvl == n;
      const bool at_root_sys = is_sys && (WIDE ? a == 0 : s == 0);
      int lit;
      if constexpr (WIDE) {
        int child = -1, adv = 0;
        probe_wide<2>(rd, state, lvl, n, w0, cw, take, child, adv);
        lit = probe && child >= 0 ? (child << kLvlBits) | (lvl + adv) : -1;
      } else {
        const int best = probe_narrow<2>(rd, state, w0);
        lit = probe ? best : -1;
      }
      const int plus = walking && !at_root_sys && nd.x >= 0
                           ? (WIDE ? ((nd.x << kLvlBits) | (lvl + 1)) : nd.x)
                           : -1;
      if (i < k) {
        out[s * nc + i] = (walking || ending) && !at_root_sys ? nd.y : -1;
        out[s * nc + k + i] = ending ? nd.z : -1;
        cand[i] = lit;
        cand[k + i] = plus;
      }
    }
    __syncwarp();
    if (nc <= 32) {
      // the descending sort of the register kernel, candidate p on lane p
      const int v = lane < nc ? cand[lane] : -1;
      const unsigned vm = __ballot_sync(kFull, v >= 0);
      int rank = 0;
      for (unsigned m = vm; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int c = __shfl_sync(kFull, v, src);
        rank += (c > v) || (c == v && src < lane);
      }
      int nxt = -1;
      for (unsigned m = vm; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int r = __shfl_sync(kFull, rank, src);
        const int c = __shfl_sync(kFull, v, src);
        if (r == lane) nxt = c;
      }
      if (lane < k) act[lane] = nxt;
      ovf |= __popc(vm) > k;
    } else {
      // the order-preserving pack, 32 candidates at a time
      int base = 0;
      for (int c0 = 0; c0 < nc; c0 += 32) {
        const int p = c0 + lane;
        const int v = p < nc ? cand[p] : -1;
        const unsigned m = __ballot_sync(kFull, v >= 0);
        const int d = base + __popc(m & ((1u << lane) - 1u));
        if (v >= 0 && d < k) act[d] = v;
        base += __popc(m);
      }
      for (int d = base + lane; d < k; d += 32) act[d] = -1;
      ovf |= base > k;
    }
    __syncwarp();
  }
  bool res = false;
  for (int i = lane; i < k; i += 32) {
    const int a = act[i];
    if (a >= 0) res |= WIDE ? ((a & kLvlMask) <= n) : (steps <= n);
  }
  res = __any_sync(kFull, res);
  if (lane == 0) ovf_out[b] = (ovf || res) ? 1 : 0;
}

}  // namespace

// slots must be the layout's entry count (2 narrow, 4 wide: take > 1);
// scratch holds 3k ints a topic and is read only when k > kMaxK or
// L > kMaxL (the register kernel takes every other walk)
extern "C" int emqx_walk(const int* word_ids, const int* n_words,
                         const int* sys_mask, const int* seed, const int* wt,
                         const int* node2, int* emits, int* ovf, int* scratch,
                         int B, int L, int k, int steps, int slots, int take,
                         int nb, void* stream) {
  const bool wide = take > 1;
  const bool gmem = k > kMaxK || L > kMaxL;
  if (k < 1 || B < 0 || L < 1 || (wide && L > kLvlMask) || steps < 0 ||
      take < 1 || take > kMaxTake || nb < 1 || (nb & (nb - 1)) ||
      slots != (wide ? kWideSlots : kNarrowSlots) ||
      (gmem && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const dim3 grid((B + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gmem) {
    auto* kernel = wide ? walk_kernel_gmem<true> : walk_kernel_gmem<false>;
    kernel<<<grid, kWarps * 32, 0, st>>>(word_ids, n_words, sys_mask, seed,
                                         wt, node2, emits, ovf, scratch, B,
                                         L, k, steps, take, nb);
    return static_cast<int>(cudaGetLastError());
  }
  // k <= 16: split rows; k <= 32: one frontier slot a lane; else two
  auto* kernel =
      wide ? (k > 32   ? walk_kernel<true, 2, false>
              : k > 16 ? walk_kernel<true, 1, false>
                       : walk_kernel<true, 1, true>)
           : (k > 32   ? walk_kernel<false, 2, false>
              : k > 16 ? walk_kernel<false, 1, false>
                       : walk_kernel<false, 1, true>);
  kernel<<<grid, kWarps * 32, 0, st>>>(word_ids, n_words, sys_mask, seed, wt,
                                       node2, emits, ovf, B, L, k, steps,
                                       take, nb);
  return static_cast<int>(cudaGetLastError());
}

// the error string of a launcher's return code (for every kernel of
// the library)
extern "C" const char* emqx_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
