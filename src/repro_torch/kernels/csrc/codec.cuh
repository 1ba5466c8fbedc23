// The four registered ECC codecs as device traits, one per codec, and the
// helpers every kernel source of this package shares.
//
// Word planes are uint32 lo/hi halves of the 64-bit data word plus a check
// plane. Each trait gives the check-plane type (uint8_t up to 8 check bits,
// uint32_t beyond), the table layout that repro_torch.codes.base.Codec
// .kernel_tables() builds (Global: the encode masks first, then the codec's
// classification tables), the prefix of it that a block copies into shared
// memory (Shared), and classify(synd, flip_lo, flip_hi) -> status (0 clean,
// 1 corrected, 2 detected). encode() is shared: check bit r is the parity of
// (lo & mask_lo[r]) ^ (hi & mask_hi[r]), one popc per check bit. The flips
// apply whatever the status (a subcode of ileave88 may correct while another
// detects), as in the reference's decode. Small tables are resolved by table
// reads in shared memory instead of the TPU kernels' compare/select chains.
//
// Each kernel of inject_scrub.cu, secded.cu and paged_gather.cu is a
// template over these traits, instantiated once per codec; its extern "C"
// launcher takes the codec id (Codec.kernel_id) and dispatches. The fused
// matmul (ecc_matmul.cu) reads SECDED planes only.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

enum CodecId : int { kParity65 = 0, kSecded72 = 1, kIleave88 = 2, kDected79 = 3 };

constexpr int kClean = 0, kCorrected = 1, kDetected = 2;

// parity65: one check bit over the whole word, detect-only; no table.
struct Parity65 {
  static constexpr int kCheck = 1;
  static constexpr bool kExact = false;
  using check_t = uint8_t;
  struct Global {
    uint32_t mask_lo[1];
    uint32_t mask_hi[1];
  };
  using Shared = Global;
  __device__ static __forceinline__ int classify(const Shared&, const Global*, uint32_t s,
                                                 uint32_t& flo, uint32_t& fhi) {
    flo = fhi = 0;
    return s ? kDetected : kClean;
  }
};
static_assert(sizeof(Parity65::Global) == 8, "layout shared with Codec.kernel_tables");

// secded72: the dense 256-entry tables, all in shared memory.
struct SecdedTables {
  uint32_t mask_lo[8];    // check bit r = parity(lo & mask_lo[r] ^ hi & mask_hi[r])
  uint32_t mask_hi[8];
  uint32_t flip_lo[256];  // data flips that correct syndrome s
  uint32_t flip_hi[256];
  uint8_t status[256];    // 0 clean, 1 corrected, 2 detected
};

struct Secded72 {
  static constexpr int kCheck = 8;
  static constexpr bool kExact = false;
  using check_t = uint8_t;
  using Global = SecdedTables;
  using Shared = SecdedTables;
  __device__ static __forceinline__ int classify(const Shared& t, const Global*, uint32_t s,
                                                 uint32_t& flo, uint32_t& fhi) {
    flo = t.flip_lo[s];
    fhi = t.flip_hi[s];
    return t.status[s];
  }
};
static_assert(sizeof(Secded72::Global) == 2368, "layout shared with Codec.kernel_tables");

// ileave88: 24 masks and the Hsiao(22,16) sub-syndrome action table (-1
// clean, -2 detected, 0..15 a data bit of the subcode, 16..21 a check bit),
// read once for each of the four interleaved subcodes.
struct Ileave88 {
  static constexpr int kCheck = 24;
  static constexpr bool kExact = true;
  using check_t = uint32_t;
  struct Global {
    uint32_t mask_lo[24];
    uint32_t mask_hi[24];
    int8_t sub_action[64];
  };
  using Shared = Global;
  __device__ static __forceinline__ int classify(const Shared& t, const Global*, uint32_t s,
                                                 uint32_t& flo, uint32_t& fhi) {
    flo = fhi = 0;
    if (s == 0) return kClean;
    bool detect = false, correct = false;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t sub = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) sub |= ((s >> (4 * r + w)) & 1u) << r;
      const int a = t.sub_action[sub];
      detect |= a == -2;
      correct |= a >= 0;
      if (a >= 0 && a < 16) {
        const int j = a * 4 + w;
        if (j < 32) flo |= 1u << j; else fhi |= 1u << (j - 32);
      }
    }
    return detect ? kDetected : correct ? kCorrected : kClean;
  }
};
static_assert(sizeof(Ileave88::Global) == 256, "layout shared with Codec.kernel_tables");

// dected79: 15 masks in shared memory; the dense 2^15-entry tables (288 KiB,
// more than a block's shared memory) stay in device memory and are read
// through the read-only path only for a word whose syndrome is not 0.
struct Dected79 {
  static constexpr int kCheck = 15;
  static constexpr bool kExact = true;
  using check_t = uint32_t;
  struct Shared {
    uint32_t mask_lo[15];
    uint32_t mask_hi[15];
  };
  struct Global {
    Shared masks;
    uint32_t flip_lo[1 << 15];
    uint32_t flip_hi[1 << 15];
    uint8_t status[1 << 15];
  };
  __device__ static __forceinline__ int classify(const Shared&, const Global* g, uint32_t s,
                                                 uint32_t& flo, uint32_t& fhi) {
    if (s == 0) {
      flo = fhi = 0;
      return kClean;
    }
    flo = __ldg(&g->flip_lo[s]);
    fhi = __ldg(&g->flip_hi[s]);
    return __ldg(&g->status[s]);
  }
};
static_assert(sizeof(Dected79::Global) == 295032, "layout shared with Codec.kernel_tables");

// Cooperative copy of the shared prefix of a codec's tables; ends with a
// barrier.
template <class C>
__device__ __forceinline__ void load_shared(typename C::Shared& dst,
                                            const typename C::Global* src, int tid,
                                            int n_threads) {
  static_assert(sizeof(typename C::Shared) % 4 == 0, "word copy");
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(&dst);
  for (int i = tid; i < int(sizeof(typename C::Shared) / 4); i += n_threads) d[i] = s[i];
  __syncthreads();
}

template <class C>
__device__ __forceinline__ uint32_t encode(const typename C::Shared& t, uint32_t lo,
                                           uint32_t hi) {
  uint32_t c = 0;
#pragma unroll
  for (int r = 0; r < C::kCheck; ++r)
    c |= uint32_t(__popc((lo & t.mask_lo[r]) ^ (hi & t.mask_hi[r])) & 1) << r;
  return c;
}

// Calls f(C{}) with the trait of codec id `id`; an unknown id returns
// cudaErrorInvalidValue.
template <class F>
int with_codec(int id, F&& f) {
  switch (id) {
    case kParity65: return f(Parity65{});
    case kSecded72: return f(Secded72{});
    case kIleave88: return f(Ileave88{});
    case kDected79: return f(Dected79{});
    default: return int(cudaErrorInvalidValue);
  }
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
