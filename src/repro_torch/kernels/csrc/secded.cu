// ECC encode and decode of word planes, for every codec of codec.cuh.
//
// decode replaces the TPU kernel decode_2d of src/repro/kernels/secded.py.
// Per word: recompute the check bits, XOR with the stored check plane to get
// the syndrome, classify it into the correction flips and the status (0
// clean, 1 corrected, 2 detected) and write the corrected words.
// Bound on the H100: bytes. Each word reads 9 bytes (12 with a 32-bit check
// plane) and writes 12 (lo, hi and an int32 status): 21 or 24 B/word at HBM
// rate, against one popc per check bit.
//
// encode replaces the TPU kernel encode_2d of the same file: the check bits
// of every (lo, hi) word. Bound: bytes, 8 read and 1 written per word
// (9 B/word; 12 with a 32-bit check plane). Its commit form also reads the
// words from an interleaved (lo, hi) payload and scatters word i of row r to
// row_base[r] + i % row_words of the destination planes, so a KV-cache token
// commit (split the f32 payload into planes, encode, scatter into the page
// arena) is one launch; it then moves 17 B/word (8 read, 9 written; 20 with a
// 32-bit check plane), plus one row base per token.
//
// Design of both: an elementwise grid-stride pass, neighbouring threads on
// neighbouring words, the codec's small tables in shared memory (dected79's
// dense tables in device memory, read only where the syndrome is not 0).
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

template <class C>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const typename C::check_t* __restrict__ chk, uint32_t* __restrict__ olo,
    uint32_t* __restrict__ ohi, int32_t* __restrict__ status,
    const typename C::Global* __restrict__ gtab, long long n) {
  __shared__ typename C::Shared tab;
  load_shared<C>(tab, gtab, threadIdx.x, blockDim.x);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t l = lo[i], h = hi[i];
    uint32_t flo, fhi;
    const int st = C::classify(tab, gtab, encode<C>(tab, l, h) ^ uint32_t(chk[i]), flo, fhi);
    olo[i] = l ^ flo;
    ohi[i] = h ^ fhi;
    status[i] = st;
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads) encode_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi, int src_stride,
    const long long* __restrict__ row_base, int row_words, uint32_t* __restrict__ olo,
    uint32_t* __restrict__ ohi, typename C::check_t* __restrict__ ochk,
    const typename C::Global* __restrict__ gtab, long long n) {
  __shared__ typename C::Shared tab;
  load_shared<C>(tab, gtab, threadIdx.x, blockDim.x);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t l = lo[i * src_stride], h = hi[i * src_stride];
    const auto c = typename C::check_t(encode<C>(tab, l, h));
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

// Check plane (the codec's check_t) of n words. Plain form (row_base null):
// lo[i], hi[i] -> ochk[i]. Commit form: the words sit at lo[i * src_stride],
// hi[i * src_stride] and go, with their check bits, to index
// row_base[i / row_words] + i % row_words of olo/ohi/ochk.
extern "C" int encode(int codec, const void* lo, const void* hi, int src_stride,
                      const void* row_base, int row_words, void* olo, void* ohi, void* ochk,
                      const void* tables, long long n, void* stream) {
  if (n <= 0) return 0;
  if (src_stride < 1 || (row_base != nullptr && row_words < 1)) return int(cudaErrorInvalidValue);
  return with_codec(codec, [&](auto c) {
    using C = decltype(c);
    encode_kernel<C><<<grid_for(n), kThreads, 0, cudaStream_t(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi), src_stride,
        static_cast<const long long*>(row_base), row_words, static_cast<uint32_t*>(olo),
        static_cast<uint32_t*>(ohi), static_cast<typename C::check_t*>(ochk),
        static_cast<const typename C::Global*>(tables), n);
    return int(cudaGetLastError());
  });
}

extern "C" int decode(int codec, const void* lo, const void* hi, const void* chk, void* olo,
                      void* ohi, void* status, const void* tables, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  return with_codec(codec, [&](auto c) {
    using C = decltype(c);
    decode_kernel<C><<<grid_for(n), kThreads, 0, cudaStream_t(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const typename C::check_t*>(chk), static_cast<uint32_t*>(olo),
        static_cast<uint32_t*>(ohi), static_cast<int32_t*>(status),
        static_cast<const typename C::Global*>(tables), n);
    return int(cudaGetLastError());
  });
}
