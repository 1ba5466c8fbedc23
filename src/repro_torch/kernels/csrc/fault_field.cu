// Undervolting fault masks drawn on the card: the failure-threshold field of
// repro_torch.core.faultsim (DeviceFaultField, interval_masks).
//
// No Pallas kernel corresponds: the reference draws the same model with
// jax.random on the device (_device_chunk_masks in
// src/repro/core/faultsim.py). This kernel takes its place, so a voltage
// step or a KV fault interval never builds a mask on the host.
//
// Model, per word w: p = clip(rate * f_row[w], 0, P_MAX = 0.5) in float32,
// thresh = uint32(p * 2^32) (the multiply by 2^32 is exact; the conversion
// truncates), and bit b of the codeword (b in 0 .. 64 + n_check) flips iff
// its uniform uint32 r_b < thresh. r_{4g+j} is output j of Philox4x32-10 at
// counter (w low 32 bits, w high 32 bits, g, 0) under the field's 64-bit
// key, so the bits depend only on (key, w): without a burst the 64 data
// planes are the same under every n_check, the stream does not depend on
// how a caller cuts the words, and voltage enters through thresh alone (lower voltage, larger
// thresh, a superset of flips: the Fault Inclusion Property). The Philox is
// written out here, not taken from cuRAND, so the plain version
// (kernels/ref.py fault_field_ref) reproduces it bit for bit.
//
// Bound on the H100: integer operations, not bytes. A word reads 4 B (f_row;
// 8 B with per-word rates) and writes 9 B (12 B beyond 8 check bits), 0.21
// ms at 55 M words and 3.35 TB/s. A secded72 word needs 18 Philox calls of
// 10 rounds, each round two 32 x 32 -> 64-bit multiplies (one IMAD.WIDE
// each, on the FMA pipe) and two three-input XORs (LOP3, on the integer
// ALU pipe), and a compare and a merge per plane: 504 ALU operations at 64
// a clock per SM, ~1.7 ms at 55 M words, with the 360 multiplies beside
// them on the other pipe. cuobjdump counts 896 instructions in the
// secded72 kernel.
//
// Design: one thread a word, every group's Philox unrolled; the round keys
// are computed on the host and passed by value, so each key XOR reads the
// constant bank. A word whose thresh is 0 (rate 0, or at or above V_min in
// a multi-rail group) skips its Philox calls and writes zeros. Neighbouring
// threads store neighbouring words.
//
// Bursts (core/scenario.py BurstProfile; the reference's expand_bursts):
// the faulty bits above are the anchors, and the same launch expands them
// into correlated multi-bit upsets, in a kernel of its own (burst_kernel) so
// the burst-free field is unchanged. Without a burst the data masks are the
// same under every n_check; with one they are not, since a plane shift
// carries bit 31 of lo into hi, bit 31 of hi into check bit 0 and truncates
// at the top check plane 63 + n_check. The stream, all from Philox counters
// that do not depend on the voltage (so FIP holds and the burst masks are a
// superset of the burst-free masks of the same key):
//   class draw of plane 4g+j:  output j of Philox at (w lo, w hi, g, 1);
//   word draw of plane 4g+j:   output j of Philox at (w lo, w hi, g, 2);
//   companion bit:             (uint64(x) * (64 + n_check)) >> 32, x output
//                              0 of Philox at (w lo, w hi, 0, 3).
// An anchor whose class draw is below t2 extends one plane up, below t3 two
// planes up; one in [t2, trd) (a random double) adds the word's companion
// bit (once a word). An anchor of word w - 1 whose word draw is below twa
// repeats at the same plane of word w; the anchors of w - 1 are drawn at
// that word's own threshold (its own f_row and rate), so a spill from a word
// of another rail keeps that rail's rate. The spill stops at the field's
// ends: word 0 gets none, the last word's is dropped. The thresholds are
// floor(p 2^32) of the cumulative class probabilities and of word_adjacent,
// 64-bit so that p = 1 (2^32) always fires. The class and word draws are
// made only for groups that hold an anchor and the companion only for a
// word with a random double: the anchors are sparse, and the draws are fixed
// by position, so drawing lazily, in whichever thread, does not change the
// stream.
//
// Burst design: a warp walks a run of kRunIters x 32 consecutive words.
// Lane L of iteration k takes word h + 32k + L, h the run's halo word, so
// each iteration's loads and stores are coalesced. The thread that owns a
// word draws its anchors once, expands them and computes its spill column
// (the anchors that repeat in the next word, from the lazy word draws); the
// column reaches word w + 1's thread in registers: __shfl_up_sync from lane
// L - 1, and for lane 0 lane 31's column of the iteration before, kept by
// __shfl_sync. Only the halo is drawn twice: lane 0 of iteration 0 draws
// word h (the last word of the run before) for its column and stores
// nothing, so a run stores kRunWords = 32 kRunIters - 1 words and the run's
// last word passes no column (the next run's halo draws it again). The run
// r's halo is word r kRunWords - 1; run 0's is word -1, which draws nothing,
// so word 0 gets no spill. kernels/ref.py fault_field_plain draws a chunk's
// word before it in the same way, and kernels/fault_field.py RUN_WORDS
// equals kRunWords (the card tests cut the field at its run edges). Lanes
// past n draw at threshold 0, join the shuffles and store nothing; the
// shuffles run after the divergent lazy loops. Without a word-adjacent
// burst (twa = 0) the halo draws nothing and no column moves.
// kRunIters = 8: R = 4, 8 and 16 timed alike on the H100 at 55 M words
// (4 was ~5% faster on a 3.4 M-word KV interval, with a shorter tail), and
// 8 keeps the redundant base draws at one per 255 words (0.4%).
//
// Work with bursts: one base Philox per group of a drawn word, as without
// a burst, so the integer bound stays the burst-free one, plus one per
// group of each run's halo word; the lazy class, word and companion draws
// add one Philox per anchored group, a few per thousand words at the
// scenario voltages. cuobjdump counts 1,872 instructions in the secded72
// burst kernel; ptxas gives it 80 registers (the loop's pointers, n, the
// halo index and the carried column stay live across the unrolled
// Philox). Capping it at 64 or 40 registers (__launch_bounds__ minimum
// blocks 4 or 6) timed the same, so no cap is set: the Philox instruction rate,
// not occupancy, bounds it.
#include <climits>
#include <type_traits>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRunIters = 8;                   // a burst run's iterations of 32 words
constexpr int kRunWords = 32 * kRunIters - 1;  // the words a run stores: fault_field.py RUN_WORDS
constexpr unsigned kWarp = 0xFFFFFFFFu;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox4x32 multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key increments

struct RoundKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                               const RoundKeys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kM0 * c0, hi0 = __umulhi(kM0, c0);
    const uint32_t lo1 = kM1 * c2, hi1 = __umulhi(kM1, c2);
    c0 = hi1 ^ c1 ^ k.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k.k1[r];
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

template <int NC>
using check_t = typename std::conditional<(NC <= 8), uint8_t, uint32_t>::type;

// Burst thresholds on uint32 draws (2^32: always); all 0 is no burst.
struct Burst {
  unsigned long long t3, t2, trd, twa;
};

// A codeword's 64 + NC planes as three 32-bit words: lo (planes 0-31), hi
// (32-63) and the check planes (64 on).
struct Bits {
  uint32_t w[3];
};

__device__ __forceinline__ uint32_t threshold(float r, float f) {
  const float p = fminf(fmaxf(r * f, 0.0f), 0.5f);
  return __float2uint_rz(p * 4294967296.0f);
}

// The base draw of word (w0, w1) at threshold t: its faulty planes.
template <int NC>
__device__ __forceinline__ Bits anchors(uint32_t w0, uint32_t w1, uint32_t t, const RoundKeys& keys) {
  constexpr int kGroups = (64 + NC + 3) / 4;
  Bits a{{0u, 0u, 0u}};
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const uint4 x = philox4x32_10(w0, w1, uint32_t(g), 0u, keys);
    const uint32_t b = uint32_t(x.x < t) | (uint32_t(x.y < t) << 1) |
                       (uint32_t(x.z < t) << 2) | (uint32_t(x.w < t) << 3);
    a.w[g >> 3] |= b << (4 * (g & 7));
  }
  a.w[2] &= (1u << NC) - 1u;
  return a;
}

// ``a`` moved k planes up (k = 1 or 2), the planes past the word cut later.
__device__ __forceinline__ Bits shift_up(const Bits& a, int k) {
  return Bits{{a.w[0] << k, (a.w[1] << k) | (a.w[0] >> (32 - k)),
               (a.w[2] << k) | (a.w[1] >> (32 - k))}};
}

// The class expansion of word (w0, w1)'s anchors ``a``: the adjacent planes
// of double and triple anchors, and the companion bit of a random double.
// The loops visit only the groups that hold an anchor (word i of ``a`` is a
// compile-time index, so the bit sets stay in registers).
template <int NC>
__device__ __forceinline__ Bits expand(const Bits& a, uint32_t w0, uint32_t w1, const RoundKeys& keys,
                                       const Burst& burst) {
  Bits out = a;
  if (burst.trd == 0 || (a.w[0] | a.w[1] | a.w[2]) == 0) return out;
  Bits e1{{0u, 0u, 0u}}, e2{{0u, 0u, 0u}};
  bool rd = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint32_t rest = a.w[i];
    while (rest != 0) {
      const int q = (__ffs(rest) - 1) >> 2;  // the group's nibble in word i
      const uint32_t m = (rest >> (4 * q)) & 0xFu;
      rest &= ~(0xFu << (4 * q));
      const uint4 c = philox4x32_10(w0, w1, uint32_t(8 * i + q), 1u, keys);
      const uint32_t cs[4] = {c.x, c.y, c.z, c.w};
      uint32_t m1 = 0, m2 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((m >> j) & 1u) {
          const unsigned long long u = cs[j];
          m1 |= uint32_t(u < burst.t2) << j;
          m2 |= uint32_t(u < burst.t3) << j;
          rd |= (u >= burst.t2) && (u < burst.trd);
        }
      }
      e1.w[i] |= m1 << (4 * q);
      e2.w[i] |= m2 << (4 * q);
    }
  }
  const Bits s1 = shift_up(e1, 1), s2 = shift_up(e2, 2);
#pragma unroll
  for (int i = 0; i < 3; ++i) out.w[i] |= s1.w[i] | s2.w[i];
  if (rd) {
    const uint32_t x = philox4x32_10(w0, w1, 0u, 3u, keys).x;
    const uint32_t eb = uint32_t((static_cast<unsigned long long>(x) * (64u + NC)) >> 32);
    const uint32_t bit = 1u << (eb & 31u);
    if (eb < 32) {
      out.w[0] |= bit;
    } else if (eb < 64) {
      out.w[1] |= bit;
    } else {
      out.w[2] |= bit;
    }
  }
  return out;
}

// The anchors ``a`` of word (w0, w1) that repeat in the next word.
__device__ __forceinline__ Bits spill(const Bits& a, uint32_t w0, uint32_t w1, const RoundKeys& keys,
                                      unsigned long long twa) {
  Bits col{{0u, 0u, 0u}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint32_t rest = a.w[i];
    while (rest != 0) {
      const int q = (__ffs(rest) - 1) >> 2;
      const uint32_t m = (rest >> (4 * q)) & 0xFu;
      rest &= ~(0xFu << (4 * q));
      const uint4 d = philox4x32_10(w0, w1, uint32_t(8 * i + q), 2u, keys);
      const uint32_t b = uint32_t((unsigned long long)d.x < twa) |
                         (uint32_t((unsigned long long)d.y < twa) << 1) |
                         (uint32_t((unsigned long long)d.z < twa) << 2) |
                         (uint32_t((unsigned long long)d.w < twa) << 3);
      col.w[i] |= (b & m) << (4 * q);
    }
  }
  return col;
}

template <int NC, bool kPerWord>
__global__ void __launch_bounds__(kThreads)
    field_kernel(const float* __restrict__ f_row, const float* __restrict__ rates, float rate,
                 const RoundKeys keys, uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                 check_t<NC>* __restrict__ chk, long long n) {
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= n) return;
  const uint32_t t = threshold(kPerWord ? rates[w] : rate, f_row[w]);
  const uint32_t w0 = uint32_t(w), w1 = uint32_t((unsigned long long)w >> 32);
  Bits out{{0u, 0u, 0u}};
  if (t != 0) out = anchors<NC>(w0, w1, t, keys);
  lo[w] = out.w[0];
  hi[w] = out.w[1];
  chk[w] = check_t<NC>(out.w[2] & ((1u << NC) - 1u));
}

template <int NC, bool kPerWord>
__global__ void __launch_bounds__(kThreads)
    burst_kernel(const float* __restrict__ f_row, const float* __restrict__ rates, float rate,
                 const RoundKeys keys, const Burst burst, uint32_t* __restrict__ lo,
                 uint32_t* __restrict__ hi, check_t<NC>* __restrict__ chk, long long n) {
  const int lane = threadIdx.x & 31;
  const long long h = (((long long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kRunWords - 1;
  if (h + 1 >= n) return;  // the whole warp: its run stores no word
  const bool spills = burst.twa != 0;
  Bits carry{{0u, 0u, 0u}};  // lane 31's column of the iteration before
#pragma unroll 1
  for (int k = 0; k < kRunIters && h + 32 * k < n; ++k) {
    const long long w = h + 32 * k + lane;
    const bool halo = k == 0 && lane == 0;
    uint32_t t = 0;
    if (w >= 0 && w < n && (spills || !halo)) t = threshold(kPerWord ? rates[w] : rate, f_row[w]);
    const uint32_t w0 = uint32_t(w), w1 = uint32_t((unsigned long long)w >> 32);
    Bits a{{0u, 0u, 0u}}, out{{0u, 0u, 0u}};
    if (t != 0) {
      a = anchors<NC>(w0, w1, t, keys);
      if (!halo) out = expand<NC>(a, w0, w1, keys, burst);
    }
    if (spills) {
      // the field's last word and the run's last word pass no column
      const bool ends = w + 1 >= n || (k == kRunIters - 1 && lane == 31);
      const Bits col = ends ? Bits{{0u, 0u, 0u}} : spill(a, w0, w1, keys, burst.twa);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint32_t up = __shfl_up_sync(kWarp, col.w[i], 1);
        out.w[i] |= lane == 0 ? carry.w[i] : up;
        carry.w[i] = __shfl_sync(kWarp, col.w[i], 31);
      }
    }
    if (!halo && w < n) {
      lo[w] = out.w[0];
      hi[w] = out.w[1];
      chk[w] = check_t<NC>(out.w[2] & ((1u << NC) - 1u));
    }
  }
}

template <int NC>
int launch(const float* f_row, const float* rates, float rate, const RoundKeys& keys,
           const Burst& burst, void* lo, void* hi, void* chk, long long n, cudaStream_t stream) {
  auto* l = static_cast<uint32_t*>(lo);
  auto* h = static_cast<uint32_t*>(hi);
  auto* c = static_cast<check_t<NC>*>(chk);
  constexpr int kWarps = kThreads / 32;
  if (burst.trd != 0 || burst.twa != 0) {
    const long long runs = (n + kRunWords - 1) / kRunWords;
    const long long blocks = (runs + kWarps - 1) / kWarps;
    if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
    if (rates != nullptr) {
      burst_kernel<NC, true><<<int(blocks), kThreads, 0, stream>>>(f_row, rates, rate, keys,
                                                                   burst, l, h, c, n);
    } else {
      burst_kernel<NC, false><<<int(blocks), kThreads, 0, stream>>>(f_row, rates, rate, keys,
                                                                    burst, l, h, c, n);
    }
  } else {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
    if (rates != nullptr) {
      field_kernel<NC, true><<<int(blocks), kThreads, 0, stream>>>(f_row, rates, rate, keys, l,
                                                                   h, c, n);
    } else {
      field_kernel<NC, false><<<int(blocks), kThreads, 0, stream>>>(f_row, rates, rate, keys, l,
                                                                    h, c, n);
    }
  }
  return int(cudaGetLastError());
}

}  // namespace

// Flip masks of n words: f_row (n,) float32 row weakness; per-word rates
// (n,) float32, or null and the scalar rate; key the field's 64-bit Philox
// key; the burst thresholds t3 <= t2 <= trd and twa (floor(p 2^32) each, in
// [0, 2^32]; all 0: no burst); n_check in {1, 8, 15, 24}. Writes lo, hi (n,)
// uint32 and chk (n,) uint8 up to 8 check bits, else uint32.
extern "C" int fault_field(int n_check, const void* f_row, const void* rates, float rate,
                           unsigned long long key, unsigned long long t3, unsigned long long t2,
                           unsigned long long trd, unsigned long long twa, void* lo, void* hi,
                           void* chk, long long n, void* stream) {
  if (n <= 0) return 0;
  constexpr unsigned long long kAlways = 1ull << 32;
  if (t3 > t2 || t2 > trd || trd > kAlways || twa > kAlways) return int(cudaErrorInvalidValue);
  RoundKeys keys;
  uint32_t k0 = uint32_t(key), k1 = uint32_t(key >> 32);
  for (int r = 0; r < 10; ++r, k0 += kW0, k1 += kW1) {
    keys.k0[r] = k0;
    keys.k1[r] = k1;
  }
  const Burst burst{t3, t2, trd, twa};
  const auto* f = static_cast<const float*>(f_row);
  const auto* rt = static_cast<const float*>(rates);
  const auto s = cudaStream_t(stream);
  switch (n_check) {
    case 1: return launch<1>(f, rt, rate, keys, burst, lo, hi, chk, n, s);
    case 8: return launch<8>(f, rt, rate, keys, burst, lo, hi, chk, n, s);
    case 15: return launch<15>(f, rt, rate, keys, burst, lo, hi, chk, n, s);
    case 24: return launch<24>(f, rt, rate, keys, burst, lo, hi, chk, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}
