// Fused undervolt fault injection + SECDED scrub over a word-plane arena.
//
// Replaces the TPU kernels inject_scrub_2d and inject_scrub_domains_2d of
// src/repro/kernels/inject_scrub.py (shared tile body _inject_classify).
// Per word: XOR the flip masks into lo/hi/check and write the faulty planes
// back, optionally re-encode the check bits over the faulty data (the no-ECC
// baseline), compute the syndrome, classify it, popcount the masks for ground
// truth, and tally the 8 counter lanes of telemetry.COUNTER_FIELDS; the
// domain variant keeps one counter row per memory domain.
//
// Bound on the H100: bytes. Each word reads 18 bytes (lo, hi, check and their
// masks; 22 with the domain id) and writes 9, against ~30 integer operations,
// so the kernel is a stream at HBM rate (3.35 TB/s): 27 B/word, 31 with
// domains. Design: a grid-stride loop with neighbouring threads on
// neighbouring words (coalesced loads), the codec tables in shared memory so
// the syndrome resolves with one table read, counters kept in registers.
// Domains are long contiguous runs of the arena, so a thread flushes its
// registers to the block's shared histogram only when its domain changes;
// at the end each warp reduces with __reduce_add_sync, the block sums in
// shared memory and issues one atomicAdd per (row, lane). Integer sums do
// not depend on order, so the counters are bit-identical to the plain
// version. A word whose domain id lies outside [0, n_rows) is injected and
// scrubbed but counted in no row, as in the plain version.
#include "secded.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;
constexpr int kMaxRows = 16;

// Adds cnt to the block's histogram row (dropped if the row is out of
// range) and clears it.
__device__ __forceinline__ void flush(int* hist, int row, int n_rows, int (&cnt)[kLanes]) {
  const bool keep = row >= 0 && row < n_rows;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (keep && cnt[l]) atomicAdd(&hist[row * kLanes + l], cnt[l]);
    cnt[l] = 0;
  }
}

template <bool kDomains>
__global__ void __launch_bounds__(kThreads) inject_scrub_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint8_t* __restrict__ chk, const uint32_t* __restrict__ mlo,
    const uint32_t* __restrict__ mhi, const uint8_t* __restrict__ mchk,
    const int32_t* __restrict__ dom, uint32_t* __restrict__ olo,
    uint32_t* __restrict__ ohi, uint8_t* __restrict__ ochk,
    int32_t* __restrict__ counters, const SecdedTables* __restrict__ gtab,
    long long n, int reencode, int n_rows) {
  __shared__ SecdedTables tab;
  __shared__ int hist[kMaxRows * kLanes];
  for (int i = threadIdx.x; i < n_rows * kLanes; i += blockDim.x) hist[i] = 0;
  load_tables(tab, gtab, threadIdx.x, blockDim.x);

  int cnt[kLanes] = {0, 0, 0, 0, 0, 0, 0, 0};
  int row = kDomains ? -1 : 0;  // the domain row cnt belongs to
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (kDomains) {
      const int d = dom[i];
      if (d != row) {
        flush(hist, row, n_rows, cnt);
        row = d;
      }
    }
    const uint32_t ml = mlo[i], mh = mhi[i], mc = mchk[i];
    const uint32_t fl = lo[i] ^ ml, fh = hi[i] ^ mh;
    const uint32_t enc = encode_check(tab, fl, fh);
    const uint32_t fc = reencode ? enc : (uint32_t(chk[i]) ^ mc);
    olo[i] = fl;
    ohi[i] = fh;
    ochk[i] = uint8_t(fc);
    const int status = tab.status[enc ^ fc];
    const int flips = __popc(ml) + __popc(mh) + __popc(mc);
    const bool detected = status == 2;
    cnt[0] += (status == 0) & (flips == 0);
    cnt[1] += (status == 1) & (flips == 1);
    cnt[2] += detected;
    cnt[3] += (flips >= 2) & !detected;
    cnt[4] += flips == 1;
    cnt[5] += flips == 2;
    cnt[6] += flips >= 3;
    cnt[7] += flips;
  }

  const int lane = threadIdx.x & 31;
  for (int r = 0; r < n_rows; ++r) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const int v = __reduce_add_sync(0xffffffffu, row == r ? cnt[l] : 0);
      if (lane == 0 && v) atomicAdd(&hist[r * kLanes + l], v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * kLanes; i += blockDim.x)
    if (hist[i]) atomicAdd(&counters[i], hist[i]);
}

template <bool kDomains>
int launch(const void* lo, const void* hi, const void* chk, const void* mlo,
           const void* mhi, const void* mchk, const void* dom, void* olo, void* ohi,
           void* ochk, void* counters, const void* tables, long long n, int reencode,
           int n_rows, void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  if (blocks > cap) blocks = cap;
  inject_scrub_kernel<kDomains><<<int(blocks), kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint8_t*>(chk), static_cast<const uint32_t*>(mlo),
      static_cast<const uint32_t*>(mhi), static_cast<const uint8_t*>(mchk),
      static_cast<const int32_t*>(dom), static_cast<uint32_t*>(olo),
      static_cast<uint32_t*>(ohi), static_cast<uint8_t*>(ochk),
      static_cast<int32_t*>(counters), static_cast<const SecdedTables*>(tables), n,
      reencode, n_rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int inject_scrub(const void* lo, const void* hi, const void* chk,
                            const void* mlo, const void* mhi, const void* mchk,
                            void* olo, void* ohi, void* ochk, void* counters,
                            const void* tables, long long n, int reencode, void* stream) {
  return launch<false>(lo, hi, chk, mlo, mhi, mchk, nullptr, olo, ohi, ochk, counters,
                       tables, n, reencode, 1, stream);
}

extern "C" int inject_scrub_domains(const void* lo, const void* hi, const void* chk,
                                    const void* mlo, const void* mhi, const void* mchk,
                                    const void* dom, void* olo, void* ohi, void* ochk,
                                    void* counters, const void* tables, long long n,
                                    int reencode, int n_rows, void* stream) {
  return launch<true>(lo, hi, chk, mlo, mhi, mchk, dom, olo, ohi, ochk, counters, tables,
                      n, reencode, n_rows, stream);
}
