// Read-time undervolting fault injection: XOR the flip masks into the three
// codeword planes (lo, hi, check) and write the faulty planes.
//
// Replaces the TPU kernel inject_2d of src/repro/kernels/fault_inject.py.
// It runs on the per-leaf reference path (one launch per protected leaf, the
// scrub follows as a separate decode) and on every read of the memory domain.
//
// Bound on the H100: bytes. Each word reads 18 bytes (lo, hi, check and their
// masks) and writes 9, against three XORs: 27 B/word at HBM rate
// (3.35 TB/s). Design: a grid-stride stream. Where every plane is aligned
// (16 bytes for the word planes, 4 for the check planes) a thread moves four
// words per step, one 16-byte load or store per word plane and one 4-byte
// access per check plane; the last n % 4 words, or all of them when a plane
// is not aligned, take one word per step. No access reaches past word n - 1,
// so a check plane of any length needs no padding.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// Words [0, 4 * n_vec) in groups of four, words [4 * n_vec, n) one by one.
__global__ void __launch_bounds__(kThreads) inject_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint8_t* __restrict__ chk, const uint32_t* __restrict__ mlo,
    const uint32_t* __restrict__ mhi, const uint8_t* __restrict__ mchk,
    uint32_t* __restrict__ olo, uint32_t* __restrict__ ohi, uint8_t* __restrict__ ochk,
    long long n, long long n_vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long g = first; g < n_vec; g += stride) {
    reinterpret_cast<uint4*>(olo)[g] =
        xor4(reinterpret_cast<const uint4*>(lo)[g], reinterpret_cast<const uint4*>(mlo)[g]);
    reinterpret_cast<uint4*>(ohi)[g] =
        xor4(reinterpret_cast<const uint4*>(hi)[g], reinterpret_cast<const uint4*>(mhi)[g]);
    reinterpret_cast<uint32_t*>(ochk)[g] =
        reinterpret_cast<const uint32_t*>(chk)[g] ^ reinterpret_cast<const uint32_t*>(mchk)[g];
  }
  for (long long i = 4 * n_vec + first; i < n; i += stride) {
    olo[i] = lo[i] ^ mlo[i];
    ohi[i] = hi[i] ^ mhi[i];
    ochk[i] = chk[i] ^ mchk[i];
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// out = planes ^ masks for n words: lo, hi, mlo, mhi, olo, ohi uint32 and
// chk, mchk, ochk uint8, each n long. Outputs must not overlap the inputs.
extern "C" int inject(const void* lo, const void* hi, const void* chk, const void* mlo,
                      const void* mhi, const void* mchk, void* olo, void* ohi, void* ochk,
                      long long n, void* stream) {
  if (n <= 0) return 0;
  const bool vec = aligned(lo, 16) && aligned(hi, 16) && aligned(mlo, 16) &&
                   aligned(mhi, 16) && aligned(olo, 16) && aligned(ohi, 16) &&
                   aligned(chk, 4) && aligned(mchk, 4) && aligned(ochk, 4);
  const long long n_vec = vec ? n / 4 : 0;
  const long long items = n_vec + (n - 4 * n_vec);
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  if (blocks > cap) blocks = cap;
  inject_kernel<<<int(blocks), kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint8_t*>(chk), static_cast<const uint32_t*>(mlo),
      static_cast<const uint32_t*>(mhi), static_cast<const uint8_t*>(mchk),
      static_cast<uint32_t*>(olo), static_cast<uint32_t*>(ohi), static_cast<uint8_t*>(ochk),
      n, n_vec);
  return int(cudaGetLastError());
}
