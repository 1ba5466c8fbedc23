// ECC encode and decode of word planes, for every codec of codec.cuh.
//
// decode replaces the TPU kernel decode_2d of src/repro/kernels/secded.py
// (tile body _decode_kernel). Per word: recompute the check bits, XOR with
// the stored check plane to get the syndrome, classify it into the
// correction flips and the status (0 clean, 1 corrected, 2 detected) and
// write the corrected words. Bound on the H100: bytes. Each word reads 9
// bytes (12 with a 32-bit check plane) and writes 12 (lo, hi and an int32
// status): 21 or 24 B/word at HBM rate.
//
// decode_kernel's design: the encode's issue must stay under the memory
// stream. The encode masks are a kernel parameter (operands from the
// constant bank, fetched once per (codec, table address) by masks_of), so
// shared memory holds only what classify reads (secded72's 2,304 B of flips
// and status, ileave88's 64-byte sub_action; load_class_tables) and, where
// the trait's kByteEncode says so (ileave88, dected79), the byte tables of
// encode_bytes, built once per block: 8 table reads a word instead of one
// popc and two mask reads from shared memory per check bit (24 for
// ileave88). dected79's dense tables stay in device memory. Each thread
// takes a quad of words per step: 16-byte loads of lo and hi and of a
// 32-bit check plane (4 bytes for a uint8 one), 16-byte stores of lo', hi'
// and the status. A quad whose four syndromes are 0 (most quads: ~4% of
// the words have a fault at 0.54 V) is stored as it came with status 0;
// only a nonzero syndrome is classified and its flips applied. The last n % 4
// words take the word path, and so does a call whose planes are not all
// aligned for quads (a view at a word offset; the outputs are new, aligned
// allocations). The callers on the main path hand it whole planes, or
// views at leaf offsets that are multiples of four words (every leaf of
// qwen3-0.6b and of the Fig. 3 MLP has a multiple of four words:
// _slice_leaves in core/planestore.py, the embedding of
// _decode_gather_table among them), so they take the quad path; chip_smoke.py
// records which path every decode on a path took. Grid: kDecodeQuads<C>
// quads a thread, chosen on the H100 among one wave of resident blocks
// walking quads grid-stride, 4, 8 and 16 such waves, and one quad a
// thread. A codec without byte tables (parity65, secded72) takes one quad
// a thread, a grid that covers the call in one pass: the more blocks, the
// faster, back to back most of all (a one-wave grid ends on its slowest
// block). Byte tables are built once a block, so there a thread walks
// enough quads to pay for the build: 16 for ileave88 (64 registers a
// thread, 4 blocks resident a SM, 896 blocks at its 14.68 M-word KV arena;
// one quad a thread was the slowest there), 2 for dected79 (32 registers,
// 8 resident, so one block's build overlaps more of the others' streams).
//
// encode replaces the TPU kernel encode_2d of the same file: the check bits
// of every (lo, hi) word. Bound: bytes, 8 read and 1 written per word
// (9 B/word; 12 with a 32-bit check plane). Design: an elementwise
// grid-stride pass, neighbouring threads on neighbouring words, the codec's
// small tables in shared memory, the popc encode.
//
// Its commit form (encode_2d as the reference's KV commit _commit_tokens in
// src/repro/core/kvpages.py uses it) reads the words from an interleaved
// (lo, hi) payload and writes word j of row r, with its check bits, to
// index row_base[r] + j of the destination planes, so a token commit (split
// the f32 payload into planes, encode, scatter into the page arena) is one
// launch. It moves 17 B/word (8 read, 9 written; 20 with a 32-bit check
// plane) plus one row base per row: 1.95 MB for the 4 rows of a decode
// step at qwen3-0.6b, well under a microsecond of HBM time (and ileave88's
// 24 popc a word about as much issue), so what bounds it is the fixed cost
// of a launch. commit_kernel adds as little to that as it can: the encode
// masks are a kernel parameter (no table copy, no shared memory, no
// barrier); each block covers one chunk of one row (one 32-bit division a
// block, none a word); each thread one quad of a row's words, loading the
// row base (one broadcast load a warp) beside its payload, so no load waits
// for another: two 16-byte loads of the payload, one 16-byte store each to
// lo and hi and one 4-byte (uint8) or 16-byte (uint32) store of the check
// bits. A quad cut by the row's end, or whose payload words are not 16-byte
// aligned (a row that starts at an odd word: odd row_words), takes word
// loads; one cut by the row's end, or whose destination is not (a row base
// off a multiple of four words, or planes off 16 bytes), word stores.
#include <climits>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

// One word's correction: a syndrome that is not 0 is classified, its flips
// applied to l and h; returns the status.
template <class C>
__device__ __forceinline__ int correct(const typename C::Shared& tab,
                                       const typename C::Global* gtab, uint32_t s,
                                       uint32_t& l, uint32_t& h) {
  if (s == 0) return kClean;
  uint32_t flo, fhi;
  const int st = C::classify(tab, gtab, s, flo, fhi);
  l ^= flo;
  h ^= fhi;
  return st;
}

// Quads a thread walks (grid-stride), by codec; see the header.
template <class C>
constexpr int kDecodeQuads = 1;
template <>
constexpr int kDecodeQuads<Dected79> = 2;
template <>
constexpr int kDecodeQuads<Ileave88> = 16;

// vec: every plane is aligned for quad loads and stores (16 bytes, 4 for a
// uint8 check plane), so the words go by quads and the last n % kQuad one
// by one; else every word by the word loop.
template <class C>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const typename C::check_t* __restrict__ chk, uint32_t* __restrict__ olo,
    uint32_t* __restrict__ ohi, int32_t* __restrict__ status,
    const typename C::Global* __restrict__ gtab, const EncodeMasks<C> masks, long long n,
    bool vec) {
  __shared__ typename C::Shared tab;  // only its classification tables are loaded
  __shared__ ByteTables<C> et;
  load_class_tables<C>(tab, gtab, threadIdx.x, blockDim.x);
  build_byte_tables(et, masks, threadIdx.x, blockDim.x);

  auto word = [&](long long i) {
    uint32_t l = lo[i], h = hi[i];
    const int st = correct<C>(tab, gtab, encode_bytes(et, masks, l, h) ^ uint32_t(chk[i]), l, h);
    olo[i] = l;
    ohi[i] = h;
    status[i] = st;
  };
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (!vec) {
    for (long long i = tid; i < n; i += stride) word(i);
    return;
  }
  const long long nq = n / kQuad, tail = kQuad * nq;
  for (long long q = tid; q < nq; q += stride) {
    const long long i = kQuad * q;
    uint32_t l[kQuad], h[kQuad], c[kQuad], s[kQuad];
    load4(lo + i, l);
    load4(hi + i, h);
    load4(chk + i, c);
#pragma unroll
    for (int k = 0; k < kQuad; ++k) s[k] = encode_bytes(et, masks, l[k], h[k]) ^ c[k];
    int st[kQuad] = {kClean, kClean, kClean, kClean};
    if (s[0] | s[1] | s[2] | s[3]) {  // the rare path
#pragma unroll
      for (int k = 0; k < kQuad; ++k) st[k] = correct<C>(tab, gtab, s[k], l[k], h[k]);
    }
    store4(olo + i, l);
    store4(ohi + i, h);
    *reinterpret_cast<int4*>(status + i) = make_int4(st[0], st[1], st[2], st[3]);
  }
  if (tid < n - tail) word(tail + tid);
}

template <class C>
__global__ void __launch_bounds__(kThreads) encode_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi, int src_stride,
    typename C::check_t* __restrict__ ochk, const typename C::Global* __restrict__ gtab,
    long long n) {
  __shared__ typename C::Shared tab;
  load_shared<C>(tab, gtab, threadIdx.x, blockDim.x);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    ochk[i] = typename C::check_t(encode<C>(tab, lo[i * src_stride], hi[i * src_stride]));
}

constexpr int kCommitThreads = 128;  // one quad a thread: 512 words of a row a block

// Block b takes chunk b % blocks_per_row of row b / blocks_per_row, and
// its thread q the row words j0 = 4q .. j0 + 3. Quads are aligned in the
// row, not in the destination, so the payload loads do not wait for the
// row base. pair_vec: the payload is interleaved (src_stride 2, hi = lo + 1)
// and 16-byte aligned, so a quad of a row whose first word is even is two
// 16-byte loads; dst_vec: olo, ohi and ochk are aligned for quad stores,
// taken where the row base is a multiple of four.
template <class C>
__global__ void __launch_bounds__(kCommitThreads) commit_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi, int src_stride,
    const long long* __restrict__ row_base, int row_words, long long n, int blocks_per_row,
    uint32_t* __restrict__ olo, uint32_t* __restrict__ ohi,
    typename C::check_t* __restrict__ ochk, const EncodeMasks<C> masks, bool pair_vec,
    bool dst_vec) {
  using T = typename C::check_t;
  const int r = blockIdx.x / blocks_per_row;
  const int j0 = 4 * ((blockIdx.x - r * blocks_per_row) * kCommitThreads + threadIdx.x);
  const long long first = (long long)r * row_words;  // the row's first source word
  const int w = n - first < row_words ? int(n - first) : row_words;
  if (j0 >= w) return;
  const bool full = j0 + 4 <= w;
  uint32_t l[4], h[4], c[4];
  if (full && pair_vec && (first & 1) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(lo + 2 * (first + j0));
    const uint4 x = p[0], y = p[1];
    l[0] = x.x, h[0] = x.y, l[1] = x.z, h[1] = x.w;
    l[2] = y.x, h[2] = y.y, l[3] = y.z, h[3] = y.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = j0 + k < w;
      const long long i = (first + j0 + k) * src_stride;
      l[k] = in ? lo[i] : 0u;
      h[k] = in ? hi[i] : 0u;
    }
  }
  const long long d0 = row_base[r] + j0;
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = encode<C>(masks, l[k], h[k]);
  if (full && dst_vec && (d0 & 3) == 0) {
    *reinterpret_cast<uint4*>(olo + d0) = make_uint4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<uint4*>(ohi + d0) = make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (sizeof(T) == 1)
      *reinterpret_cast<uint32_t*>(ochk + d0) = c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
    else
      *reinterpret_cast<uint4*>(ochk + d0) = make_uint4(c[0], c[1], c[2], c[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (j0 + k >= w) continue;
    olo[d0 + k] = l[k];
    ohi[d0 + k] = h[k];
    ochk[d0 + k] = T(c[k]);
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  return int(blocks > cap ? cap : blocks);
}

}  // namespace

// Check plane (the codec's check_t) of n words. Plain form (row_base null):
// lo[i * src_stride], hi[i * src_stride] -> ochk[i]. Commit form: the words
// sit at lo[i * src_stride], hi[i * src_stride] and go, with their check
// bits, to index row_base[i / row_words] + i % row_words of olo/ohi/ochk
// (commit_kernel; its masks are read from tables once, see masks_of).
extern "C" int encode(int codec, const void* lo, const void* hi, int src_stride,
                      const void* row_base, int row_words, void* olo, void* ohi, void* ochk,
                      const void* tables, long long n, void* stream) {
  if (n <= 0) return 0;
  if (src_stride < 1 || (row_base != nullptr && row_words < 1)) return int(cudaErrorInvalidValue);
  cudaStream_t s = cudaStream_t(stream);
  return with_codec(codec, [&](auto c) {
    using C = decltype(c);
    using T = typename C::check_t;
    const auto l = static_cast<const uint32_t*>(lo);
    const auto h = static_cast<const uint32_t*>(hi);
    if (row_base == nullptr) {
      encode_kernel<C><<<grid_for(n), kThreads, 0, s>>>(
          l, h, src_stride, static_cast<T*>(ochk),
          static_cast<const typename C::Global*>(tables), n);
      return int(cudaGetLastError());
    }
    const long long rows = (n + row_words - 1) / row_words;
    const long long quads = (row_words + 3LL) / 4;
    const long long per_row = (quads + kCommitThreads - 1) / kCommitThreads;
    if (rows * per_row > INT_MAX) return int(cudaErrorInvalidValue);
    EncodeMasks<C> masks;
    const int err = masks_of<C>(tables, masks);
    if (err) return err;
    const bool pair_vec = src_stride == 2 && h == l + 1 && aligned(l, 16);
    const bool dst_vec = aligned(olo, 16) && aligned(ohi, 16) && aligned(ochk, 4 * sizeof(T));
    commit_kernel<C><<<int(rows * per_row), kCommitThreads, 0, s>>>(
        l, h, src_stride, static_cast<const long long*>(row_base), row_words, n, int(per_row),
        static_cast<uint32_t*>(olo), static_cast<uint32_t*>(ohi), static_cast<T*>(ochk), masks,
        pair_vec, dst_vec);
    return int(cudaGetLastError());
  });
}

extern "C" int decode(int codec, const void* lo, const void* hi, const void* chk, void* olo,
                      void* ohi, void* status, const void* tables, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  return with_codec(codec, [&](auto c) {
    using C = decltype(c);
    using T = typename C::check_t;
    const uintptr_t q = 16, qc = kQuad * sizeof(T);  // a quad of a plane, of a check plane
    const bool vec = aligned(lo, q) && aligned(hi, q) && aligned(chk, qc) && aligned(olo, q) &&
                     aligned(ohi, q) && aligned(status, q);
    const long long items = vec ? n / kQuad + kQuad : n;
    const long long per_block = (long long)kThreads * kDecodeQuads<C>;
    const long long blocks = (items + per_block - 1) / per_block;
    if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
    EncodeMasks<C> masks;
    const int err = masks_of<C>(tables, masks);
    if (err) return err;
    decode_kernel<C><<<int(blocks), kThreads, 0, cudaStream_t(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const T*>(chk), static_cast<uint32_t*>(olo), static_cast<uint32_t*>(ohi),
        static_cast<int32_t*>(status), static_cast<const typename C::Global*>(tables), masks, n,
        vec);
    return int(cudaGetLastError());
  });
}
