// Hsiao SECDED(72,64) device helpers shared by the kernels of this package.
//
// Word planes are uint32 lo/hi halves of the 64-bit data word plus a uint8
// check plane. The codec tables arrive as one device buffer laid out as
// SecdedTables (built by repro_torch.codes.base.Codec.kernel_tables) and are
// copied into shared memory once per block: the syndrome is resolved by one
// table read instead of the TPU kernels' compare/select chains.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct SecdedTables {
  uint32_t mask_lo[8];    // check bit r = parity(lo & mask_lo[r] ^ hi & mask_hi[r])
  uint32_t mask_hi[8];
  uint32_t flip_lo[256];  // data flips that correct syndrome s
  uint32_t flip_hi[256];
  uint8_t status[256];    // 0 clean, 1 corrected, 2 detected
};

static_assert(sizeof(SecdedTables) == 2368, "layout shared with Codec.kernel_tables");

// Cooperative copy of the tables into shared memory; ends with a barrier.
__device__ __forceinline__ void load_tables(SecdedTables& dst, const SecdedTables* src,
                                            int tid, int n_threads) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(&dst);
  for (int i = tid; i < int(sizeof(SecdedTables) / 4); i += n_threads) d[i] = s[i];
  __syncthreads();
}

__device__ __forceinline__ uint32_t encode_check(const SecdedTables& t, uint32_t lo,
                                                 uint32_t hi) {
  uint32_t c = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    c |= uint32_t(__popc((lo & t.mask_lo[r]) ^ (hi & t.mask_hi[r])) & 1) << r;
  return c;
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
