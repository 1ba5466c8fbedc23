// SECDED encode and decode of word planes.
//
// decode replaces the TPU kernel decode_2d of src/repro/kernels/secded.py.
// Per word: recompute the check bits, XOR with the stored check plane to get
// the syndrome, look up the correction flips and the status (0 clean,
// 1 corrected, 2 detected) and write the corrected words.
// Bound on the H100: bytes. Each word reads 9 bytes and writes 12 (lo, hi and
// an int32 status) against ~25 integer operations: 21 B/word at HBM rate.
//
// encode replaces the TPU kernel encode_2d of the same file: the check byte
// of every (lo, hi) word. Bound: bytes, 8 read and 1 written per word
// (9 B/word) against ~40 integer operations. Its commit form also reads the
// words from an interleaved (lo, hi) payload and scatters word i of row r to
// row_base[r] + i % row_words of the destination planes, so a KV-cache token
// commit (split the f32 payload into planes, encode, scatter into the page
// arena) is one launch; it then moves 17 B/word (8 read, 9 written), plus
// one row base per token.
//
// Design of both: an elementwise grid-stride pass, neighbouring threads on
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

__global__ void __launch_bounds__(kThreads) encode_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi, int src_stride,
    const long long* __restrict__ row_base, int row_words, uint32_t* __restrict__ olo,
    uint32_t* __restrict__ ohi, uint8_t* __restrict__ ochk,
    const SecdedTables* __restrict__ gtab, long long n) {
  __shared__ SecdedTables tab;
  load_tables(tab, gtab, threadIdx.x, blockDim.x);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t l = lo[i * src_stride], h = hi[i * src_stride];
    const uint8_t c = uint8_t(encode_check(tab, l, h));
    if (row_base == nullptr) {
      ochk[i] = c;
    } else {
      const long long dst = row_base[i / row_words] + i % row_words;
      olo[dst] = l;
      ohi[dst] = h;
      ochk[dst] = c;
    }
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  return int(blocks > cap ? cap : blocks);
}

}  // namespace

// Check plane of n words. Plain form (row_base null): lo[i], hi[i] ->
// ochk[i]. Commit form: the words sit at lo[i * src_stride], hi[i *
// src_stride] and go, with their check byte, to index row_base[i / row_words]
// + i % row_words of olo/ohi/ochk.
extern "C" int encode(const void* lo, const void* hi, int src_stride, const void* row_base,
                      int row_words, void* olo, void* ohi, void* ochk, const void* tables,
                      long long n, void* stream) {
  if (n <= 0) return 0;
  if (src_stride < 1 || (row_base != nullptr && row_words < 1)) return int(cudaErrorInvalidValue);
  encode_kernel<<<grid_for(n), kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi), src_stride,
      static_cast<const long long*>(row_base), row_words, static_cast<uint32_t*>(olo),
      static_cast<uint32_t*>(ohi), static_cast<uint8_t*>(ochk),
      static_cast<const SecdedTables*>(tables), n);
  return int(cudaGetLastError());
}

extern "C" int decode(const void* lo, const void* hi, const void* chk, void* olo,
                      void* ohi, void* status, const void* tables, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  decode_kernel<<<grid_for(n), kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint8_t*>(chk), static_cast<uint32_t*>(olo),
      static_cast<uint32_t*>(ohi), static_cast<int32_t*>(status),
      static_cast<const SecdedTables*>(tables), n);
  return int(cudaGetLastError());
}
