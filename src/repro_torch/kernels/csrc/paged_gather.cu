// Paged KV-cache scrub-on-read: gather pages by id, correct, count, write back
// the words that change.
//
// Replaces the TPU kernel gather_scrub_2d of src/repro/kernels/paged_gather.py
// (body _gather_scrub_kernel) together with the gather by page id and the
// scatter write-back around it (kvpages._scrub_rows), for every codec of
// codec.cuh. For each of P page ids and each of the W words of that page in
// the flat arena planes: syndrome, classification, corrected lo/hi, and check
// bits re-encoded over the corrected data except on detected words, which
// keep their stored check bits so the DED flag stays latched (their
// corrected words still carry the flips of any subcode that corrected, as in
// the reference). Outputs: the corrected words as the f32 payload (lo, hi
// interleaved: the reference's _planes_to_payload fused in), one (clean,
// corrected, detected) counter row per page id (lanes 0..2 of 8), and the
// write-back of the corrected planes into the arena. Every row, duplicate ids
// included, comes from the words as they were before the call.
//
// Bound on the H100: bytes. Each word of a distinct page id is read once (9
// B with a uint8 check plane, 12 B with a 32-bit one), each row's payload
// written once (8 B a row word, duplicate rows included), and each distinct
// word that changes written back once (9 / 12 B more): 17 / 20 B a word
// where no id repeats. Operations: one encode (one popc per check bit) per
// distinct word, one more per corrected one. A word whose syndrome is 0 is
// clean and unchanged (encode(lo, hi) equals its stored check bits and no
// flip applies), so it causes no store to the arena.
//
// Design. The table's rows are cut into chunks of 32 quads (128 words); a
// quad is four words aligned to four in the arena, so a page whose base
// id * W is not a multiple of four starts inside its first quad and ends
// inside its last. Each warp of scrub_kernel walks a contiguous run of
// (row, chunk) pairs (a grid of as many blocks as fit on the card at once):
// a lane loads its quad of lo and hi with one 16-byte load each and the
// check bits with one 4-byte (uint8 plane) or 16-byte (32-bit plane) load,
// encodes the four words once, writes their payload (two 16-byte stores
// where the payload row is aligned) and counts them in registers (one warp
// reduction and atomic per row it leaves). The encode masks are a kernel
// parameter, so every mask is an operand from the constant bank and takes
// no register; codecs of more than 8 check bits encode by 8 reads of byte
// tables in shared memory (codec.cuh's encode_bytes, built by each block
// from the masks) instead of one popc per check bit. Words whose syndrome is not 0 take the rare path:
// classify, correct, and re-encode unless detected. A lane takes its
// pending words in turn, so a warp runs that path as many times as its
// busiest lane has such words. What is written back depends on whether
// another row of the table holds the same page id (the scheduler fills
// lanes' tails with the scratch page):
// - a row whose id is unique in the table writes its changed words back at
//   once: no other row reads them;
// - of the rows that share an id, the first (the leader) records, per chunk
//   with a change, one ballot per quad position of the words whose data
//   changed and one of those whose check bits changed, and appends the
//   chunk to a list (at most one entry per chunk: it cannot overflow); the
//   other rows write nothing, since they change the same words to the same
//   values. writeback_kernel, launched after, walks that list and writes
//   the recorded words from the payload, re-encoding the check bits of the
//   second kind.
// No result depends on the order in which blocks run.
#include <climits>
#include <cstring>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;         // counter row
constexpr int kChunkQuads = 32;   // one quad per lane
constexpr int kRecordWords = 9;   // per chunk: 4 data-changed and 4 check-changed
                                  // ballots, and one write-back list entry
constexpr unsigned kFull = 0xffffffffu;

// A table row in the arena: quad word p of the row is arena word abase + p,
// row word p - a, payload word pay + p.
struct RowGeo {
  long long abase, pay;
  int a;
};

__device__ __forceinline__ RowGeo row_geo(const int32_t* ids, int row, long long W) {
  const long long base = (long long)ids[row] * W;
  const int a = int(base & 3);
  return {base - a, (long long)row * W - a, a};
}

enum Role { kDirect, kLead, kFollow };

// kDirect where no other row of the table holds row's page id, else kLead
// for its first row and kFollow for the others (the same answer in every
// lane).
__device__ int row_role(const int32_t* ids, int n_rows, int row) {
  const int id = ids[row];
  bool before = false, after = false;
  for (int i = threadIdx.x & 31; i < n_rows; i += 32) {
    if (ids[i] != id) continue;
    before |= i < row;
    after |= i > row;
  }
  if (__any_sync(kFull, before)) return kFollow;
  return __any_sync(kFull, after) ? kLead : kDirect;
}

// The contiguous run [g, end) of the n_rows * chunks (row, chunk) pairs that
// this warp walks.
__device__ __forceinline__ void warp_run(long long total, long long& g, long long& end) {
  const long long warps = (long long)gridDim.x * kWarps;
  const long long per = (total + warps - 1) / warps;
  g = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32 * per;
  end = g + per < total ? g + per : total;
}

template <class T>
__device__ __forceinline__ T pick(const T (&v)[4], int k) {
  T r = v[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (k == i) r = v[i];
  return r;
}

template <class T>
__device__ __forceinline__ void put(T (&v)[4], int k, T x) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k == i) v[i] = x;
}

// One lane's quad: the stored words, and bit k of `valid` set where quad
// word k lies in the row.
struct Quad {
  uint32_t lo[4], hi[4], chk[4];
  int valid;
};

template <class T>
__device__ __forceinline__ void load_quad(Quad& x, const uint32_t* lo, const uint32_t* hi,
                                          const T* chk, const RowGeo& r, long long W, int q,
                                          bool vec) {
  const long long j0 = 4LL * q - r.a;
  const long long at = r.abase + 4LL * q;
  if (vec && j0 >= 0 && j0 + 4 <= W) {
    const uint4 l = *reinterpret_cast<const uint4*>(lo + at);
    const uint4 h = *reinterpret_cast<const uint4*>(hi + at);
    x.lo[0] = l.x, x.lo[1] = l.y, x.lo[2] = l.z, x.lo[3] = l.w;
    x.hi[0] = h.x, x.hi[1] = h.y, x.hi[2] = h.z, x.hi[3] = h.w;
    if constexpr (sizeof(T) == 1) {
      const uint32_t c = *reinterpret_cast<const uint32_t*>(chk + at);
#pragma unroll
      for (int k = 0; k < 4; ++k) x.chk[k] = (c >> (8 * k)) & 0xffu;
    } else {
      const uint4 c = *reinterpret_cast<const uint4*>(chk + at);
      x.chk[0] = c.x, x.chk[1] = c.y, x.chk[2] = c.z, x.chk[3] = c.w;
    }
    x.valid = 0xf;
    return;
  }
  x.valid = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = j0 + k >= 0 && j0 + k < W;
    x.valid |= int(in) << k;
    x.lo[k] = in ? lo[at + k] : 0u;
    x.hi[k] = in ? hi[at + k] : 0u;
    x.chk[k] = in ? uint32_t(chk[at + k]) : 0u;
  }
}

// Scrubs one quad: corrected words and check bits to write back, bit k of
// dmask / cmask where word k's data / check bits change; adds the corrected
// and detected words to the counts.
template <class C>
__device__ __forceinline__ void scrub_quad(const typename C::Shared& tab,
                                           const typename C::Global* gtab,
                                           const ByteTables<C>& et, const EncodeMasks<C>& m,
                                           const Quad& x,
                                           uint32_t (&cl)[4], uint32_t (&ch)[4],
                                           uint32_t (&nc)[4], int& dmask, int& cmask,
                                           int& corrected, int& detected) {
  uint32_t syn[4];
  int pending = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cl[k] = x.lo[k], ch[k] = x.hi[k], nc[k] = x.chk[k];
    syn[k] = encode_bytes(et, m, x.lo[k], x.hi[k]) ^ x.chk[k];
    pending |= int(syn[k] != 0 && ((x.valid >> k) & 1)) << k;
  }
  dmask = cmask = 0;
  while (pending) {
    const int k = __ffs(pending) - 1;
    pending &= pending - 1;
    const uint32_t stored = pick(nc, k), s = pick(syn, k);
    uint32_t flo, fhi;
    const int status = C::classify(tab, gtab, s, flo, fhi);
    const uint32_t l = pick(cl, k) ^ flo, h = pick(ch, k) ^ fhi;
    const uint32_t c = status == kDetected ? stored : encode_bytes(et, m, l, h);
    corrected += status == kCorrected;
    detected += status == kDetected;
    dmask |= int((flo | fhi) != 0) << k;
    cmask |= int(c != stored) << k;
    put(cl, k, l);
    put(ch, k, h);
    put(nc, k, c);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads) scrub_kernel(
    uint32_t* lo, uint32_t* hi, typename C::check_t* chk, const int32_t* __restrict__ ids,
    int n_rows, long long W, int chunks, uint2* __restrict__ payload,
    uint4* __restrict__ record, int32_t* __restrict__ list, int32_t* __restrict__ counters,
    const typename C::Global* __restrict__ gtab, const EncodeMasks<C> masks, bool vec) {
  using T = typename C::check_t;
  __shared__ typename C::Shared tab;
  __shared__ ByteTables<C> et;
  load_shared<C>(tab, gtab, threadIdx.x, blockDim.x);
  build_byte_tables(et, masks, threadIdx.x, kThreads);
  long long g, end;
  warp_run((long long)n_rows * chunks, g, end);
  if (g >= end) return;
  const int lane = threadIdx.x & 31;
  int row = int(g / chunks), c = int(g - (long long)row * chunks);
  int cur = row, role = row_role(ids, n_rows, row);
  int words = 0, corrected = 0, detected = 0;

  auto flush = [&](int r) {
    const int n0 = __reduce_add_sync(kFull, words - corrected - detected);
    const int n1 = __reduce_add_sync(kFull, corrected), n2 = __reduce_add_sync(kFull, detected);
    const int n = lane == 0 ? n0 : lane == 1 ? n1 : n2;
    if (lane < 3 && n) atomicAdd(&counters[(long long)r * kLanes + lane], n);
    words = corrected = detected = 0;
  };
  auto step = [&](long long gi, int r, int ci, const RowGeo& geo, const Quad& x) {
    if (r != cur) {
      flush(cur);
      cur = r;
      role = row_role(ids, n_rows, r);
    }
    uint32_t cl[4], ch[4], nc[4];
    int dmask, cmask;
    scrub_quad<C>(tab, gtab, et, masks, x, cl, ch, nc, dmask, cmask, corrected, detected);
    words += __popc(x.valid);
    const int q = ci * kChunkQuads + lane;
    const long long pw = geo.pay + 4LL * q;
    if (x.valid == 0xf && (pw & 1) == 0 && vec) {
      uint4* p4 = reinterpret_cast<uint4*>(payload + pw);
      p4[0] = make_uint4(cl[0], ch[0], cl[1], ch[1]);
      p4[1] = make_uint4(cl[2], ch[2], cl[3], ch[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((x.valid >> k) & 1) payload[pw + k] = make_uint2(cl[k], ch[k]);
    }
    if (role == kDirect) {
      const long long at = geo.abase + 4LL * q;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((dmask >> k) & 1) lo[at + k] = cl[k], hi[at + k] = ch[k];
        if ((cmask >> k) & 1) chk[at + k] = T(nc[k]);
      }
    } else if (role == kLead && __any_sync(kFull, dmask | cmask)) {
      uint32_t bd[4], bc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bd[k] = __ballot_sync(kFull, (dmask >> k) & 1);
        bc[k] = __ballot_sync(kFull, (cmask >> k) & 1);
      }
      if (lane == 0) {
        record[2 * gi] = make_uint4(bd[0], bd[1], bd[2], bd[3]);
        record[2 * gi + 1] = make_uint4(bc[0], bc[1], bc[2], bc[3]);
        list[atomicAdd(&counters[(long long)n_rows * kLanes], 1)] = int(gi);
      }
    }
  };

  for (; g < end; ++g) {
    const RowGeo geo = row_geo(ids, row, W);
    Quad x;
    load_quad(x, lo, hi, chk, geo, W, c * kChunkQuads + lane, vec);
    step(g, row, c, geo, x);
    if (++c == chunks) c = 0, ++row;
  }
  flush(cur);
}

// Writes back the chunks on scrub_kernel's list (those of leader rows with
// a change): data from the payload, check bits re-encoded from it.
template <class C>
__global__ void __launch_bounds__(kThreads) writeback_kernel(
    uint32_t* __restrict__ lo, uint32_t* __restrict__ hi, typename C::check_t* __restrict__ chk,
    const int32_t* __restrict__ ids, long long W, int chunks, const uint2* __restrict__ payload,
    const uint4* __restrict__ record, const int32_t* __restrict__ list,
    const int32_t* __restrict__ list_len, const EncodeMasks<C> masks) {
  using T = typename C::check_t;
  const int n = *list_len, lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int i = (blockIdx.x * kThreads + threadIdx.x) / 32; i < n; i += warps) {
    const int g = list[i], row = g / chunks, c = g - row * chunks;
    const RowGeo geo = row_geo(ids, row, W);
    const uint4 d = record[2LL * g], e = record[2LL * g + 1];
    const uint32_t bd[4] = {d.x, d.y, d.z, d.w}, bc[4] = {e.x, e.y, e.z, e.w};
    const long long p0 = 4LL * (c * kChunkQuads + lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool dk = (bd[k] >> lane) & 1, ck = (bc[k] >> lane) & 1;
      if (!(dk || ck)) continue;
      const uint2 w = payload[geo.pay + p0 + k];
      const long long at = geo.abase + p0 + k;
      if (dk) lo[at] = w.x, hi[at] = w.y;
      if (ck) chk[at] = T(encode<C>(masks, w.x, w.y));
    }
  }
}

// Chunks of one table row: a row of W words starts up to three words into
// its first quad (the wrapper's chunks_per_row counts the same).
long long chunks_per_row(long long words_per_page) {
  const long long quads = (words_per_page + 3 + 3) / 4;
  return (quads + kChunkQuads - 1) / kChunkQuads;
}

template <class K>
int resident_blocks(K kernel) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (per_sm > 0 ? per_sm : 1) * sm_count();
}

}  // namespace

// Scrub-on-read of n_rows pages (ids in page_ids, each in [0, arena pages))
// of words_per_page words: payload (n_rows, words_per_page) uint2, counters
// (n_rows + 1, 8) int32 zeroed by the caller (row n_rows, lane 0: the length
// of the write-back list), record scratch of record_words int32 (at least 9
// per chunk of every row); lo/hi/chk are the flat arena planes, read and
// then written back where a word changes. tables is the codec's table
// struct on the device, host_tables the same bytes on the host (its masks
// are passed by value).
extern "C" int gather_scrub(int codec, void* lo, void* hi, void* chk, const void* page_ids,
                            int n_rows, long long words_per_page, void* payload, void* record,
                            long long record_words, void* counters, const void* tables,
                            const void* host_tables, void* stream) {
  if (n_rows <= 0 || words_per_page <= 0) return 0;
  const long long chunks = chunks_per_row(words_per_page);
  const long long total = (long long)n_rows * chunks;
  if (total > INT_MAX || record_words < total * kRecordWords) return int(cudaErrorInvalidValue);
  const long long want = (total + kWarps - 1) / kWarps;
  cudaStream_t s = cudaStream_t(stream);
  return with_codec(codec, [&](auto c) {
    using C = decltype(c);
    using T = typename C::check_t;
    static const int resident1 = resident_blocks(scrub_kernel<C>);
    static const int resident2 = resident_blocks(writeback_kernel<C>);
    EncodeMasks<C> masks;
    std::memcpy(&masks, host_tables, sizeof(masks));
    const bool vec = aligned(lo, 16) && aligned(hi, 16) && aligned(payload, 16) &&
                     aligned(chk, sizeof(T) == 1 ? 4 : 16);
    const auto ids = static_cast<const int32_t*>(page_ids);
    uint4* rec = static_cast<uint4*>(record);
    int32_t* list = static_cast<int32_t*>(record) + 8 * total;
    int32_t* cnt = static_cast<int32_t*>(counters);
    scrub_kernel<C><<<int(want < resident1 ? want : resident1), kThreads, 0, s>>>(
        static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), static_cast<T*>(chk), ids,
        n_rows, words_per_page, int(chunks), static_cast<uint2*>(payload), rec, list, cnt,
        static_cast<const typename C::Global*>(tables), masks, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    writeback_kernel<C><<<int(want < resident2 ? want : resident2), kThreads, 0, s>>>(
        static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), static_cast<T*>(chk), ids,
        words_per_page, int(chunks), static_cast<const uint2*>(payload), rec, list,
        cnt + (long long)n_rows * kLanes, masks);
    return int(cudaGetLastError());
  });
}
