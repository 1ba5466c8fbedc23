// Read-time undervolting fault injection: XOR the flip masks into the three
// codeword planes (lo, hi, check) and write the faulty planes.
//
// Replaces the TPU kernel inject_2d of src/repro/kernels/fault_inject.py.
// It runs on the per-leaf reference path (one launch per protected leaf, the
// scrub follows as a separate decode) and on every read of the memory domain.
//
// Bound on the H100: bytes. Each word reads 18 bytes (lo, hi, check and their
// masks) and writes 9, against three XORs: 27 B/word at HBM rate
// (3.35 TB/s). PyTorch's own XOR (torch.bitwise_xor, three calls: the plain
// version) computes the same function as three streams of the same bytes.
//
// Design: the three XORs in one launch, plane after plane, in one pass with
// no grid-stride loop. The planes are XORed independently, so each (plane,
// mask, output) triple that is 16-byte aligned is cut into 4 KB chunks, one
// a block of 256 threads, and thread t of a chunk XORs its uint4 t (4 words
// of lo or hi, 16 of the uint8 check plane): neighbouring threads on
// neighbouring 16 bytes, every access 16 bytes wide. The lo chunks come
// first, then hi's, then the check plane's; blocks start roughly in index
// order, so the card streams about one triple at a time (two reads and a
// write, like each of PyTorch's three kernels) rather than nine streams at
// once. Measured on the H100 against variants of this kernel (not kept):
// evict-first loads (__ldcs) and 16 words a thread over all three triples
// were both slower; two uint4 a thread of one triple were no faster, four
// or eight slower.
// A triple's words past its last whole chunk, or all of them when it
// is not aligned (a view at a word offset), take the word path in the blocks
// after the chunks: one word a thread. No access reaches past word n - 1,
// so a check plane of any length needs no padding.
#include <climits>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 16LL * kThreads;  // one uint4 a thread

// One (plane, mask, output) triple of n words: its first `chunks` chunks go
// by 16-byte accesses, its words from `tail` on by the word path.
template <class T>
struct Triple {
  const T* x;
  const T* m;
  T* o;
  long long chunks;
  long long tail;
};

template <class T>
Triple<T> triple(const void* x, const void* m, void* o, long long n) {
  const bool vec = aligned(x, 16) && aligned(m, 16) && aligned(o, 16);
  const long long chunks = vec ? n * sizeof(T) / kChunkBytes : 0;
  return {static_cast<const T*>(x), static_cast<const T*>(m), static_cast<T*>(o), chunks,
          chunks * kChunkBytes / (long long)sizeof(T)};
}

template <class T>
__device__ __forceinline__ void xor_chunk(const Triple<T>& p, long long c) {
  const long long v = c * kThreads + threadIdx.x;
  const uint4 a = reinterpret_cast<const uint4*>(p.x)[v];
  const uint4 b = reinterpret_cast<const uint4*>(p.m)[v];
  reinterpret_cast<uint4*>(p.o)[v] = make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <class T>
__device__ __forceinline__ void xor_word(const Triple<T>& p, long long j, long long n) {
  const long long i = p.tail + j;
  if (i < n) p.o[i] = p.x[i] ^ p.m[i];
}

__global__ void __launch_bounds__(kThreads) inject_kernel(Triple<uint32_t> lo,
                                                          Triple<uint32_t> hi,
                                                          Triple<uint8_t> chk, long long n) {
  long long b = blockIdx.x;
  if (b < lo.chunks) return xor_chunk(lo, b);
  b -= lo.chunks;
  if (b < hi.chunks) return xor_chunk(hi, b);
  b -= hi.chunks;
  if (b < chk.chunks) return xor_chunk(chk, b);
  b -= chk.chunks;
  const long long j = b * kThreads + threadIdx.x;  // the j-th word of each tail
  xor_word(lo, j, n);
  xor_word(hi, j, n);
  xor_word(chk, j, n);
}

}  // namespace

// out = planes ^ masks for n words: lo, hi, mlo, mhi, olo, ohi uint32 and
// chk, mchk, ochk uint8, each n long. Outputs must not overlap the inputs.
extern "C" int inject(const void* lo, const void* hi, const void* chk, const void* mlo,
                      const void* mhi, const void* mchk, void* olo, void* ohi, void* ochk,
                      long long n, void* stream) {
  if (n <= 0) return 0;
  const auto l = triple<uint32_t>(lo, mlo, olo, n), h = triple<uint32_t>(hi, mhi, ohi, n);
  const auto c = triple<uint8_t>(chk, mchk, ochk, n);
  long long tail = n - l.tail;
  if (n - h.tail > tail) tail = n - h.tail;
  if (n - c.tail > tail) tail = n - c.tail;
  const long long blocks = l.chunks + h.chunks + c.chunks + (tail + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  inject_kernel<<<int(blocks), kThreads, 0, cudaStream_t(stream)>>>(l, h, c, n);
  return int(cudaGetLastError());
}
