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
// key, so the bits depend only on (key, w): the 64 data planes are the same
// under every n_check, the stream does not depend on how a caller cuts the
// words, and voltage enters through thresh alone (lower voltage, larger
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
#include <climits>
#include <type_traits>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
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

template <int NC, bool kPerWord>
__global__ void __launch_bounds__(kThreads)
    field_kernel(const float* __restrict__ f_row, const float* __restrict__ rates, float rate,
                 const RoundKeys keys, uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                 check_t<NC>* __restrict__ chk, long long n) {
  constexpr int kGroups = (64 + NC + 3) / 4;
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= n) return;
  const float r = kPerWord ? rates[w] : rate;
  const float p = fminf(fmaxf(r * f_row[w], 0.0f), 0.5f);
  const uint32_t t = __float2uint_rz(p * 4294967296.0f);
  uint32_t mlo = 0, mhi = 0, mchk = 0;
  if (t != 0) {
    const uint32_t w0 = uint32_t(w), w1 = uint32_t((unsigned long long)w >> 32);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint4 x = philox4x32_10(w0, w1, uint32_t(g), 0u, keys);
      const uint32_t b = uint32_t(x.x < t) | (uint32_t(x.y < t) << 1) |
                         (uint32_t(x.z < t) << 2) | (uint32_t(x.w < t) << 3);
      if (g < 8) {
        mlo |= b << (4 * g);
      } else if (g < 16) {
        mhi |= b << (4 * g - 32);
      } else {
        mchk |= b << (4 * g - 64);
      }
    }
  }
  lo[w] = mlo;
  hi[w] = mhi;
  chk[w] = check_t<NC>(mchk & ((1u << NC) - 1u));
}

template <int NC>
int launch(const float* f_row, const float* rates, float rate, const RoundKeys& keys, void* lo,
           void* hi, void* chk, long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  auto* l = static_cast<uint32_t*>(lo);
  auto* h = static_cast<uint32_t*>(hi);
  auto* c = static_cast<check_t<NC>*>(chk);
  if (rates != nullptr) {
    field_kernel<NC, true><<<int(blocks), kThreads, 0, stream>>>(f_row, rates, rate, keys, l, h, c, n);
  } else {
    field_kernel<NC, false><<<int(blocks), kThreads, 0, stream>>>(f_row, rates, rate, keys, l, h, c,
                                                                  n);
  }
  return int(cudaGetLastError());
}

}  // namespace

// Flip masks of n words: f_row (n,) float32 row weakness; per-word rates
// (n,) float32, or null and the scalar rate; key the field's 64-bit Philox
// key; n_check in {1, 8, 15, 24}. Writes lo, hi (n,) uint32 and chk (n,)
// uint8 up to 8 check bits, else uint32.
extern "C" int fault_field(int n_check, const void* f_row, const void* rates, float rate,
                           unsigned long long key, void* lo, void* hi, void* chk, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  RoundKeys keys;
  uint32_t k0 = uint32_t(key), k1 = uint32_t(key >> 32);
  for (int r = 0; r < 10; ++r, k0 += kW0, k1 += kW1) {
    keys.k0[r] = k0;
    keys.k1[r] = k1;
  }
  const auto* f = static_cast<const float*>(f_row);
  const auto* rt = static_cast<const float*>(rates);
  const auto s = cudaStream_t(stream);
  switch (n_check) {
    case 1: return launch<1>(f, rt, rate, keys, lo, hi, chk, n, s);
    case 8: return launch<8>(f, rt, rate, keys, lo, hi, chk, n, s);
    case 15: return launch<15>(f, rt, rate, keys, lo, hi, chk, n, s);
    case 24: return launch<24>(f, rt, rate, keys, lo, hi, chk, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}
