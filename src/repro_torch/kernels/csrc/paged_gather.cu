// Paged KV-cache scrub-on-read: gather pages by id, correct, count, write back.
//
// Replaces the TPU kernel gather_scrub_2d of src/repro/kernels/paged_gather.py
// (body _gather_scrub_kernel) together with the gather by page id and the
// scatter write-back around it (kvpages._scrub_rows). For each of P page ids
// and each of the W words of that page in the flat arena planes: syndrome,
// 256-entry table lookup, corrected lo/hi, and check bits re-encoded over the
// corrected data except on detected words, which keep their stored check bits
// so the DED flag stays latched. Outputs: the corrected words as the f32
// payload (lo, hi interleaved: the reference's _planes_to_payload fused in),
// one (clean, corrected, detected) counter row per page id (lanes 0..2 of 8),
// and the write-back of the corrected planes into the arena.
//
// Bound on the H100: bytes, 26 per word (9 read, 9 written back, 8 of
// payload) against ~60 integer operations.
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
#include "secded.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;

__global__ void __launch_bounds__(kThreads) scrub_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint8_t* __restrict__ chk, const int32_t* __restrict__ page_ids,
    long long words_per_page, uint2* __restrict__ payload, uint8_t* __restrict__ stage_chk,
    int32_t* __restrict__ counters, const SecdedTables* __restrict__ gtab) {
  __shared__ SecdedTables tab;
  __shared__ int hist[3];
  if (threadIdx.x < 3) hist[threadIdx.x] = 0;
  load_tables(tab, gtab, threadIdx.x, blockDim.x);

  const long long row = blockIdx.y;
  const long long src = (long long)page_ids[row] * words_per_page;
  const long long dst = row * words_per_page;
  int clean = 0, corrected = 0, detected = 0;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < words_per_page;
       j += (long long)gridDim.x * blockDim.x) {
    const uint32_t l = lo[src + j], h = hi[src + j];
    const uint32_t stored = chk[src + j];
    const uint32_t s = encode_check(tab, l, h) ^ stored;
    const int status = tab.status[s];
    const uint32_t cl = l ^ tab.flip_lo[s], ch = h ^ tab.flip_hi[s];
    payload[dst + j] = make_uint2(cl, ch);
    stage_chk[dst + j] = uint8_t(status == 2 ? stored : encode_check(tab, cl, ch));
    clean += status == 0;
    corrected += status == 1;
    detected += status == 2;
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

__global__ void __launch_bounds__(kThreads) writeback_kernel(
    const uint2* __restrict__ payload, const uint8_t* __restrict__ stage_chk,
    const int32_t* __restrict__ page_ids, long long words_per_page, uint32_t* __restrict__ lo,
    uint32_t* __restrict__ hi, uint8_t* __restrict__ chk) {
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
// scratch; lo/hi/chk are the flat arena planes, read and then written back.
extern "C" int gather_scrub(void* lo, void* hi, void* chk, const void* page_ids, int n_rows,
                            long long words_per_page, void* payload, void* stage_chk,
                            void* counters, const void* tables, void* stream) {
  if (n_rows <= 0 || words_per_page <= 0) return 0;
  if (n_rows > 65535) return int(cudaErrorInvalidValue);
  long long cols = (words_per_page + kThreads - 1) / kThreads;
  // Enough blocks to fill the card twice over across all rows, at most one
  // thread per word.
  long long want = (2LL * 16 * sm_count() + n_rows - 1) / n_rows;
  if (cols > want) cols = want;
  const dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(n_rows));
  cudaStream_t s = cudaStream_t(stream);
  scrub_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint8_t*>(chk), static_cast<const int32_t*>(page_ids),
      words_per_page, static_cast<uint2*>(payload), static_cast<uint8_t*>(stage_chk),
      static_cast<int32_t*>(counters), static_cast<const SecdedTables*>(tables));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  writeback_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint2*>(payload), static_cast<const uint8_t*>(stage_chk),
      static_cast<const int32_t*>(page_ids), words_per_page, static_cast<uint32_t*>(lo),
      static_cast<uint32_t*>(hi), static_cast<uint8_t*>(chk));
  return int(cudaGetLastError());
}
