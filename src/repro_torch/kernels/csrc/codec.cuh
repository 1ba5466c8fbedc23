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
// (lo & mask_lo[r]) ^ (hi & mask_hi[r]), one popc per check bit;
// encode_bytes() computes the same bits by byte tables where the trait's
// kByteEncode says so (ByteTables below): the one choice of encode for the
// kernels that encode many words a block. The flips apply whatever the
// status (a subcode of ileave88 may correct while another detects), as in
// the reference's decode. Small tables are resolved by table reads in
// shared memory instead of the TPU kernels' compare/select chains.
//
// Each kernel of inject_scrub.cu, secded.cu and paged_gather.cu is a
// template over these traits, instantiated once per codec; its extern "C"
// launcher takes the codec id (Codec.kernel_id) and dispatches. The fused
// matmul (ecc_matmul.cu) reads SECDED planes only.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

enum CodecId : int { kParity65 = 0, kSecded72 = 1, kIleave88 = 2, kDected79 = 3 };

constexpr int kClean = 0, kCorrected = 1, kDetected = 2;

// parity65: one check bit over the whole word, detect-only; no table.
struct Parity65 {
  static constexpr int kCheck = 1;
  static constexpr bool kExact = false;
  static constexpr bool kByteEncode = false;
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
  static constexpr bool kByteEncode = false;
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
  static constexpr bool kByteEncode = true;
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
  static constexpr bool kByteEncode = true;
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

// The classification tables alone: the words of a codec's Shared tables
// past its encode masks (secded72's flips and status, ileave88's
// sub_action; none for parity65 and dected79), for a kernel that takes the
// masks by value. Cooperative copy into the same offsets of dst; ends with a
// barrier where there is anything to copy.
template <class C>
__device__ __forceinline__ void load_class_tables(typename C::Shared& dst,
                                                  const typename C::Global* src, int tid,
                                                  int n_threads) {
  constexpr int kMaskWords = 2 * C::kCheck;
  constexpr int kWords = int(sizeof(typename C::Shared) / 4) - kMaskWords;
  if constexpr (kWords > 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src) + kMaskWords;
    uint32_t* d = reinterpret_cast<uint32_t*>(&dst) + kMaskWords;
    for (int i = tid; i < kWords; i += n_threads) d[i] = s[i];
    __syncthreads();
  }
}

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

// The encode by one popc per check bit. t is any holder of the codec's
// masks as mask_lo / mask_hi: its Shared tables, or EncodeMasks.
template <class C, class M>
__device__ __forceinline__ uint32_t encode(const M& t, uint32_t lo, uint32_t hi) {
  uint32_t c = 0;
#pragma unroll
  for (int r = 0; r < C::kCheck; ++r)
    c |= uint32_t(__popc((lo & t.mask_lo[r]) ^ (hi & t.mask_hi[r])) & 1) << r;
  return c;
}

// A codec's encode masks alone, for a kernel that takes them by value as a
// parameter (each mask an operand from the constant bank, no register); the
// same bytes as the head of its Global tables.
template <class C>
struct EncodeMasks {
  uint32_t mask_lo[C::kCheck];
  uint32_t mask_hi[C::kCheck];
};

// The encode masks of the codec table struct at `tables` (device memory),
// for a launcher that passes them by value and is given the tables on the
// device only. A codec's masks are constants, so they are read once per
// (codec, table address) by a blocking copy (the first launch waits for the
// device once) and kept on the host.
template <class C>
int masks_of(const void* tables, EncodeMasks<C>& out) {
  struct Entry {
    const void* at;
    EncodeMasks<C> masks;
  };
  static std::mutex mu;
  static Entry seen[8];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].at == tables) {
      out = seen[i].masks;
      return 0;
    }
  const cudaError_t err = cudaMemcpy(&out, tables, sizeof(out), cudaMemcpyDeviceToHost);
  if (err != cudaSuccess) return int(err);
  if (n_seen < 8) seen[n_seen++] = {tables, out};
  return 0;
}

// The encode by byte tables, for the codecs whose trait sets kByteEncode
// (ileave88's 24 and dected79's 15 check bits). The encode is linear: a
// word's check bits are the XOR of those of its 8 bytes, bytes[256 * b + v]
// for value v at byte b, so it takes 8 reads of shared memory instead of one
// popc per check bit. The other codecs keep the popc encode and the tables
// are empty. The paged scrub (paged_gather.cu), the inject+scrub
// (inject_scrub.cu) and the decode (secded.cu) encode so; only the encode
// (secded.cu, its plain and its token-commit form) takes the popc encode.
// kByteEncode was chosen on the H100 against the popc encode with masks by
// value: ileave88's tables are faster in the paged scrub and the
// inject+scrub; dected79's ~10% faster in the paged scrub and ~1% slower
// in the inject+scrub, so it takes them too.
template <class C>
struct ByteTables {
  static constexpr bool kUsed = C::kByteEncode;
  uint32_t col[kUsed ? 64 : 1];  // check bits of data bit i alone
  uint32_t bytes[kUsed ? 8 * 256 : 1];
};

// Cooperative build of the byte tables from the masks; ends with a barrier.
template <class C, class M>
__device__ void build_byte_tables(ByteTables<C>& t, const M& masks, int tid, int n_threads) {
  if constexpr (ByteTables<C>::kUsed) {
    for (int i = tid; i < 64; i += n_threads)
      t.col[i] = encode<C>(masks, i < 32 ? 1u << i : 0u, i < 32 ? 0u : 1u << (i - 32));
    __syncthreads();
    for (int e = tid; e < 8 * 256; e += n_threads) {
      uint32_t c = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((e >> j) & 1) c ^= t.col[8 * (e >> 8) + j];
      t.bytes[e] = c;
    }
    __syncthreads();
  }
}

// encode<C>, by the byte tables where the codec has them.
template <class C, class M>
__device__ __forceinline__ uint32_t encode_bytes(const ByteTables<C>& t, const M& masks,
                                                 uint32_t lo, uint32_t hi) {
  if constexpr (ByteTables<C>::kUsed) {
    const uint32_t* b = t.bytes;
    return b[lo & 255] ^ b[256 + ((lo >> 8) & 255)] ^ b[512 + ((lo >> 16) & 255)] ^
           b[768 + (lo >> 24)] ^ b[1024 + (hi & 255)] ^ b[1280 + ((hi >> 8) & 255)] ^
           b[1536 + ((hi >> 16) & 255)] ^ b[1792 + (hi >> 24)];
  } else {
    return encode<C>(masks, lo, hi);
  }
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

constexpr int kQuad = 4;  // words of a quad: one 16-byte load or store of a uint32 plane

// Four consecutive values of a plane from one aligned load: a uint4, or for
// a uint8 plane a 4-byte word split into its bytes.
template <class T>
__device__ __forceinline__ void load4(const T* p, uint32_t (&v)[kQuad]) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < kQuad; ++k) v[k] = (w >> (8 * k)) & 0xffu;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  }
}

template <class T>
__device__ __forceinline__ void store4(T* p, const uint32_t (&v)[kQuad]) {
  if constexpr (sizeof(T) == 1)
    *reinterpret_cast<uint32_t*>(p) = v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
  else
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
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
