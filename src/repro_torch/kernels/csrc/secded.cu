// SECDED decode of word planes: corrected lo/hi and a per-word status.
//
// Replaces the TPU kernel decode_2d of src/repro/kernels/secded.py. Per word:
// recompute the check bits, XOR with the stored check plane to get the
// syndrome, look up the correction flips and the status (0 clean,
// 1 corrected, 2 detected) and write the corrected words.
//
// Bound on the H100: bytes. Each word reads 9 bytes and writes 12 (lo, hi and
// an int32 status) against ~25 integer operations: 21 B/word at HBM rate.
// Design: an elementwise grid-stride pass, neighbouring threads on
// neighbouring words, the codec tables in shared memory so the syndrome
// resolves with one table read per output.
#include "secded.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) decode_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint8_t* __restrict__ chk, uint32_t* __restrict__ olo,
    uint32_t* __restrict__ ohi, int32_t* __restrict__ status,
    const SecdedTables* __restrict__ gtab, long long n) {
  __shared__ SecdedTables tab;
  load_tables(tab, gtab, threadIdx.x, blockDim.x);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t l = lo[i], h = hi[i];
    const uint32_t s = encode_check(tab, l, h) ^ chk[i];
    olo[i] = l ^ tab.flip_lo[s];
    ohi[i] = h ^ tab.flip_hi[s];
    status[i] = tab.status[s];
  }
}

}  // namespace

extern "C" int decode(const void* lo, const void* hi, const void* chk, void* olo,
                      void* ohi, void* status, const void* tables, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  if (blocks > cap) blocks = cap;
  decode_kernel<<<int(blocks), kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint8_t*>(chk), static_cast<uint32_t*>(olo),
      static_cast<uint32_t*>(ohi), static_cast<int32_t*>(status),
      static_cast<const SecdedTables*>(tables), n);
  return int(cudaGetLastError());
}
