// Paged KV-cache scrub-on-read: gather pages by id, correct, count, write back.
//
// Replaces the TPU kernel gather_scrub_2d of src/repro/kernels/paged_gather.py
// (body _gather_scrub_kernel) together with the gather by page id and the
// scatter write-back around it (kvpages._scrub_rows), for every codec of
// codec.cuh. For each of P page ids and each of the W words of that page in
// the flat arena planes: syndrome, classification, corrected lo/hi, and check
// bits re-encoded over the corrected data except on detected words, which
// keep their stored check bits so the DED flag stays latched (their
// corrected words still carry the flips of any subcode that corrected, as in
// the reference). Outputs: the corrected words as the f32
// payload (lo, hi interleaved: the reference's _planes_to_payload fused in),
// one (clean, corrected, detected) counter row per page id (lanes 0..2 of 8),
// and the write-back of the corrected planes into the arena.
//
// Bound on the H100: bytes, 26 per word (9 read, 9 written back, 8 of
// payload) with a uint8 check plane, 32 with a 32-bit one, against two
// encodes (one popc per check bit each) per word.
//
// Design. Phase 1 (scrub_kernel): a 2D grid, blockIdx.y the page row,
// blockIdx.x column blocks of that page; threads stride over the page's words
// with neighbouring threads on neighbouring words, read the arena rows
// themselves by page id, write the payload as one 8-byte store per word and
// the check bits to a staging plane, and keep the three counts in registers:
// warp reduce, then one atomicAdd per (page, lane) per block. Phase 2
// (writeback_kernel) copies payload and staged check bits into the arena.
// Two phases because a page id may appear several times in one table (the
// scheduler fills lanes' tails with the scratch page): every row's outputs
// and counters must come from the words as they were before the launch, as
// in the reference, which gathers every row before it writes any. Duplicate
// rows then write identical words, so the write-back is idempotent.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;

template <class C>
__global__ void __launch_bounds__(kThreads) scrub_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const typename C::check_t* __restrict__ chk, const int32_t* __restrict__ page_ids,
    long long words_per_page, uint2* __restrict__ payload,
    typename C::check_t* __restrict__ stage_chk, int32_t* __restrict__ counters,
    const typename C::Global* __restrict__ gtab) {
  __shared__ typename C::Shared tab;
  __shared__ int hist[3];
  if (threadIdx.x < 3) hist[threadIdx.x] = 0;
  load_shared<C>(tab, gtab, threadIdx.x, blockDim.x);

  const long long row = blockIdx.y;
  const long long src = (long long)page_ids[row] * words_per_page;
  const long long dst = row * words_per_page;
  int clean = 0, corrected = 0, detected = 0;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < words_per_page;
       j += (long long)gridDim.x * blockDim.x) {
    const uint32_t l = lo[src + j], h = hi[src + j];
    const uint32_t stored = chk[src + j];
    uint32_t flo, fhi;
    const int status = C::classify(tab, gtab, encode<C>(tab, l, h) ^ stored, flo, fhi);
    const uint32_t cl = l ^ flo, ch = h ^ fhi;
    payload[dst + j] = make_uint2(cl, ch);
    stage_chk[dst + j] =
        typename C::check_t(status == kDetected ? stored : encode<C>(tab, cl, ch));
    clean += status == kClean;
    corrected += status == kCorrected;
    detected += status == kDetected;
  }
  clean = __reduce_add_sync(0xffffffffu, clean);
  corrected = __reduce_add_sync(0xffffffffu, corrected);
  detected = __reduce_add_sync(0xffffffffu, detected);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&hist[0], clean);
    atomicAdd(&hist[1], corrected);
    atomicAdd(&hist[2], detected);
  }
  __syncthreads();
  if (threadIdx.x < 3 && hist[threadIdx.x])
    atomicAdd(&counters[row * kLanes + threadIdx.x], hist[threadIdx.x]);
}

template <class T>
__global__ void __launch_bounds__(kThreads) writeback_kernel(
    const uint2* __restrict__ payload, const T* __restrict__ stage_chk,
    const int32_t* __restrict__ page_ids, long long words_per_page, uint32_t* __restrict__ lo,
    uint32_t* __restrict__ hi, T* __restrict__ chk) {
  const long long row = blockIdx.y;
  const long long dst = (long long)page_ids[row] * words_per_page;
  const long long src = row * words_per_page;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < words_per_page;
       j += (long long)gridDim.x * blockDim.x) {
    const uint2 w = payload[src + j];
    lo[dst + j] = w.x;
    hi[dst + j] = w.y;
    chk[dst + j] = stage_chk[src + j];
  }
}

}  // namespace

// Scrub-on-read of n_rows pages (ids in page_ids, each in [0, arena rows))
// of words_per_page words: payload (n_rows, words_per_page) uint2, counters
// (n_rows, 8) int32 zeroed by the caller, stage_chk (n_rows, words_per_page)
// scratch of the codec's check_t; lo/hi/chk are the flat arena planes, read
// and then written back.
extern "C" int gather_scrub(int codec, void* lo, void* hi, void* chk, const void* page_ids,
                            int n_rows, long long words_per_page, void* payload,
                            void* stage_chk, void* counters, const void* tables,
                            void* stream) {
  if (n_rows <= 0 || words_per_page <= 0) return 0;
  if (n_rows > 65535) return int(cudaErrorInvalidValue);
  long long cols = (words_per_page + kThreads - 1) / kThreads;
  // Enough blocks to fill the card twice over across all rows, at most one
  // thread per word.
  long long want = (2LL * 16 * sm_count() + n_rows - 1) / n_rows;
  if (cols > want) cols = want;
  const dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(n_rows));
  cudaStream_t s = cudaStream_t(stream);
  return with_codec(codec, [&](auto c) {
    using C = decltype(c);
    using T = typename C::check_t;
    scrub_kernel<C><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const T*>(chk), static_cast<const int32_t*>(page_ids), words_per_page,
        static_cast<uint2*>(payload), static_cast<T*>(stage_chk),
        static_cast<int32_t*>(counters), static_cast<const typename C::Global*>(tables));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    writeback_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const uint2*>(payload), static_cast<const T*>(stage_chk),
        static_cast<const int32_t*>(page_ids), words_per_page, static_cast<uint32_t*>(lo),
        static_cast<uint32_t*>(hi), static_cast<T*>(chk));
    return int(cudaGetLastError());
  });
}
