// Fused SECDED decode + int8 dequant + matmul: the ECC read path of every
// protected weight matrix, out[m, n] = scale[n] * sum_k x[m, k] * W[k, n].
//
// Replaces the TPU kernel ecc_matmul_2d of src/repro/kernels/ecc_matmul.py
// (body _matmul_kernel), including the scale multiply its wrapper
// ops.ecc_matmul applies. W is stored as Hsiao (K/8, N) planes: codeword i of
// column n holds the int8 weights W[j*K/8 + i, n], byte j of the 64-bit word
// (bytes 0-3 in lo, 4-7 in hi). The TPU wrapper permutes x to match
// (ops.permute_k); here x is read in its natural layout and the 8i+j
// interleave is folded into the index instead.
//
// One sum order, whatever M (so a row's output is the same floats in every
// call, the row invariance the exact-token checks rest on). With K8 = K/8
// codeword rows cut into chunks of 8 (chunk c holds rows 8c..8c+7, the last
// padded with zero rows):
//
//   total = 0
//   for c ascending:
//     part = 0
//     for j in 0..7, for ii in 0..7:     // byte j of codeword row 8c + ii
//       part = fma(x[m, j*K8 + 8c + ii], W_j(8c + ii, n), part)
//     total = total + part
//   out[m, n] = total * scale[n]
//
// Padded rows run their FMAs (x = 0, W = 0) in both kernels. The intrinsics
// are written out so contraction cannot make the kernels differ.
//
// Two kernels, picked by M in the one launcher (and by K: the decode
// kernel's shared memory grows with K, past ~8,800 the tiled kernel takes
// every M):
// - M > kDecodeMaxM (prefill, speculative verify, the MLP at M = 4,000):
//   ecc_matmul_kernel, bound by the 2*M*K*N float32 multiply-adds (FFMA
//   against the 67 TFLOP/s float32 peak). One block per 32 x 64 output tile,
//   a loop over the chunks; each step decodes its 512 plane words once
//   (syndrome from the shared-memory tables, single-bit correction),
//   sign-extends them into a float tile in shared memory, stages the
//   matching 32 x 64 x-tile, and every thread runs the chain for a 2 x 4
//   sub-tile in registers.
// - M <= kDecodeMaxM (decode, the draft model, the serve lanes):
//   ecc_matmul_decode_kernel, bound by the bytes of the planes (9/8 B per
//   weight), in practice by latency: a 32 x 64 tile would be 7/8 padding at
//   M = 4 and give 16-48 blocks for 132 SMs. Here a block of 512 threads
//   owns 8 output columns and all of K (128-384 blocks at qwen3-0.6b
//   widths). It copies its activations into shared memory (cp.async, rows
//   in groups of 4) while its threads load, correct and store the block's
//   (K/8, 8) plane words (8 threads read 32 consecutive bytes of a plane
//   row); then one thread runs the chain of one (row, chunk, column), the
//   bytes turned into floats on the fly, and writes the chunk's sum to
//   shared memory; one thread per (row, column) folds the sums in ascending
//   chunk order. Nothing runs 7/8 padding, and no thread walks all of K.
//
// Tensor cores, TMA and wgmma are later work. Sums run in another order
// than the plain version, so the results agree with it within
// 1e-4 * max|plain|, not bit for bit.
#include "secded.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK8 = 8;  // codeword rows per chunk
constexpr int kBK = 8 * kBK8;

// Tiled kernel.
constexpr int kBM = 32;  // output rows per block
constexpr int kBN = 64;  // output columns per block

// Decode kernel.
constexpr int kDecodeMaxM = 16;  // largest M it takes
constexpr int kDThreads = 512;
constexpr int kDCols = 8;        // output columns per block
constexpr int kDRows = 4;        // activation rows staged at a time
constexpr int kDBatch = 4;       // words a thread loads at once
// Dynamic shared memory a block may take beside the tables (227 KB in all);
// a larger K (K8 above ~1,100) goes to the tiled kernel.
constexpr size_t kDecodeMaxSmem = 232448 - sizeof(SecdedTables);

__global__ void __launch_bounds__(kThreads) ecc_matmul_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ hi, const uint8_t* __restrict__ chk,
    const float* __restrict__ scale, float* __restrict__ out,
    const SecdedTables* __restrict__ gtab, int M, int K8, int N) {
  __shared__ SecdedTables tab;
  __shared__ float xs[kBM][kBK + 1];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  load_tables(tab, gtab, tid, kThreads);

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = tid % 16, ty = tid / 16;  // rows 2*ty..+1, columns 4*tx..+3
  const long long K = 8LL * K8;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int i0 = 0; i0 < K8; i0 += kBK8) {
    // Decode this chunk's plane words; tile row j*kBK8 + ii holds byte j of
    // codeword row i0 + ii, i.e. weight row j*K8 + i0 + ii.
    for (int w = tid; w < kBK8 * kBN; w += kThreads) {
      const int ii = w / kBN, c = w % kBN;
      const int i = i0 + ii, n = n0 + c;
      uint32_t l = 0, h = 0;
      if (i < K8 && n < N) {
        const long long idx = (long long)i * N + n;
        l = lo[idx];
        h = hi[idx];
        const uint32_t s = encode_check(tab, l, h) ^ chk[idx];
        l ^= tab.flip_lo[s];
        h ^= tab.flip_hi[s];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ws[j * kBK8 + ii][c] = float(int8_t(l >> (8 * j)));
        ws[(4 + j) * kBK8 + ii][c] = float(int8_t(h >> (8 * j)));
      }
    }
    // The matching activations, in the same tile-row order.
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int j = kk / kBK8, ii = kk % kBK8;
      const int m = m0 + r, i = i0 + ii;
      xs[r][kk] = (m < M && i < K8) ? x[(long long)m * K + (long long)j * K8 + i] : 0.f;
    }
    __syncthreads();
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a[2] = {xs[2 * ty][kk], xs[2 * ty + 1][kk]};
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[r][c] = __fmaf_rn(a[r], b[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __fadd_rn(acc[r][c], part[r][c]);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + 2 * ty + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (n < N) out[(long long)m * N + n] = __fmul_rn(acc[r][c], scale[n]);
    }
  }
}

// Byte j of w as an exact float: (byte ^ 0x80) in the low mantissa bits of
// 2^23, less 2^23 + 128 (one PRMT and one FADD; I2F runs at a quarter rate).
__device__ __forceinline__ float int8_to_float(uint32_t w_x80, int j) {
  return __fsub_rn(__int_as_float(int(__byte_perm(w_x80, 0x4B000000u, 0x7540u + j))),
                   8388736.f);
}

// Asynchronous copy of `bytes` (4 or 16) from global to shared memory;
// zero-fills the destination when !ok (nothing is read then).
template <int bytes>
__device__ __forceinline__ void cp_async(void* smem, const float* gmem, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
               "n"(bytes), "r"(ok ? bytes : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dynamic shared memory of the decode kernel: corrected words [K8p][kDCols]
// (uint2), one group of activation rows [kDRows][K] (float), chunk sums
// [n_chunks][kDRows * kDCols] (float); K8p = 8 * n_chunks.
inline size_t decode_smem_bytes(int K8) {
  const size_t n_chunks = (K8 + kBK8 - 1) / kBK8;
  return n_chunks * kBK8 * kDCols * 8 + size_t(kDRows) * 8 * K8 * 4 +
         n_chunks * kDRows * kDCols * 4;
}

// kVec: x is 16-byte aligned and K8 % 4 == 0, so activations move in
// 16-byte copies and every run of 8 of them is two float4 reads.
template <bool kVec>
__global__ void __launch_bounds__(kDThreads, 3) ecc_matmul_decode_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ hi, const uint8_t* __restrict__ chk,
    const float* __restrict__ scale, float* __restrict__ out,
    const SecdedTables* __restrict__ gtab, int M, int K8, int N) {
  __shared__ SecdedTables tab;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, n0 = blockIdx.x * kDCols;
  const int K = 8 * K8, n_chunks = (K8 + kBK8 - 1) / kBK8;
  const int n_words = n_chunks * kBK8 * kDCols;
  uint2* ws = reinterpret_cast<uint2*>(smem);
  float* xs = reinterpret_cast<float*>(ws + n_words);
  float* parts = xs + kDRows * K;

  // Activation rows m0..m0+kDRows-1 into xs (zeros past M), asynchronously.
  auto stage_x = [&](int m0) {
    constexpr int v = kVec ? 4 : 1;
    for (int e = tid; e < kDRows * K / v; e += kDThreads) {
      const int r = e / (K / v), f = v * (e % (K / v));
      const bool ok = m0 + r < M;
      cp_async<4 * v>(xs + r * K + f, ok ? x + (long long)(m0 + r) * K + f : x, ok);
    }
  };
  stage_x(0);

  // Decode the block's (K8p, kDCols) words, kDBatch per thread at a time:
  // word w is codeword row w / kDCols of column n0 + w % kDCols; rows past
  // K8 and columns past N decode as zero. Stored with bytes ^ 0x80, for
  // int8_to_float.
  for (int w0 = 0; w0 < n_words; w0 += kDThreads * kDBatch) {
    uint32_t rl[kDBatch], rh[kDBatch], rc[kDBatch];
#pragma unroll
    for (int b = 0; b < kDBatch; ++b) {
      const int w = w0 + b * kDThreads + tid, i = w / kDCols, n = n0 + w % kDCols;
      const bool ok = w < n_words && i < K8 && n < N;
      const long long idx = (long long)i * N + n;
      rl[b] = ok ? lo[idx] : 0u;
      rh[b] = ok ? hi[idx] : 0u;
      rc[b] = ok ? chk[idx] : 0u;
    }
    if (w0 == 0) load_tables(tab, gtab, tid, kDThreads);  // while the words load
#pragma unroll
    for (int b = 0; b < kDBatch; ++b) {
      const int w = w0 + b * kDThreads + tid;
      if (w < n_words) {
        const uint32_t s = encode_check(tab, rl[b], rh[b]) ^ rc[b];
        ws[w] = make_uint2((rl[b] ^ tab.flip_lo[s]) ^ 0x80808080u,
                           (rh[b] ^ tab.flip_hi[s]) ^ 0x80808080u);
      }
    }
  }

  // Thread tid < M * kDCols owns output (tid / kDCols, column tid % kDCols).
  float total = 0.f;
  for (int m0 = 0; m0 < M; m0 += kDRows) {
    cp_async_wait_all();
    __syncthreads();  // words and this group's rows in place, last fold done
    // One chain per (row, chunk, column), the column fastest.
    const int n_items = min(kDRows, M - m0) * n_chunks * kDCols;
    for (int it = tid; it < n_items; it += kDThreads) {
      const int col = it % kDCols, c = (it / kDCols) % n_chunks, r = it / (kDCols * n_chunks);
      const int i0 = kBK8 * c;
      uint2 wv[kBK8];
#pragma unroll
      for (int ii = 0; ii < kBK8; ++ii) wv[ii] = ws[(i0 + ii) * kDCols + col];
      const float* xr = xs + r * K + i0;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a[kBK8];
        if (kVec) {
          const float4 a0 = *reinterpret_cast<const float4*>(xr + j * K8);
          const float4 a1 = i0 + 4 < K8 ? *reinterpret_cast<const float4*>(xr + j * K8 + 4)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
          a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
          a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        } else {
#pragma unroll
          for (int ii = 0; ii < kBK8; ++ii) a[ii] = i0 + ii < K8 ? xr[j * K8 + ii] : 0.f;
        }
#pragma unroll
        for (int ii = 0; ii < kBK8; ++ii)
          part = __fmaf_rn(a[ii], int8_to_float(j < 4 ? wv[ii].x : wv[ii].y, j & 3), part);
      }
      parts[c * (kDRows * kDCols) + r * kDCols + col] = part;
    }
    __syncthreads();
    if (m0 + kDRows < M) stage_x(m0 + kDRows);  // the next group loads during the fold
    const int own = tid - m0 * kDCols;  // (row - m0, column) of this thread's output
    if (tid < M * kDCols && own >= 0 && own < kDRows * kDCols) {
#pragma unroll 8
      for (int c = 0; c < n_chunks; ++c) total = __fadd_rn(total, parts[c * (kDRows * kDCols) + own]);
    }
  }
  if (tid < M * kDCols) {
    const int m = tid / kDCols, n = n0 + tid % kDCols;
    if (n < N) out[(long long)m * N + n] = __fmul_rn(total, scale[n]);
  }
}

// One launch per call: the decode kernel for M <= kDecodeMaxM (when its
// shared memory fits), the tiled kernel otherwise. Both take the one sum
// order, so the choice never changes a row's floats.
template <bool kVec>
void launch_decode(const float* x, const uint32_t* lo, const uint32_t* hi, const uint8_t* chk,
                   const float* scale, float* out, const SecdedTables* tab, int M, int K8, int N,
                   size_t smem, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ecc_matmul_decode_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kDecodeMaxSmem));
  (void)attr;  // a refused attribute shows as a refused launch
  ecc_matmul_decode_kernel<kVec><<<(N + kDCols - 1) / kDCols, kDThreads, smem, s>>>(
      x, lo, hi, chk, scale, out, tab, M, K8, N);
}

}  // namespace

extern "C" int ecc_matmul(const void* x, const void* lo, const void* hi, const void* chk,
                          const void* scale, void* out, const void* tables, int M, int K8,
                          int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const auto xf = static_cast<const float*>(x);
  const auto lo_ = static_cast<const uint32_t*>(lo);
  const auto hi_ = static_cast<const uint32_t*>(hi);
  const auto chk_ = static_cast<const uint8_t*>(chk);
  const auto scale_ = static_cast<const float*>(scale);
  const auto out_ = static_cast<float*>(out);
  const auto tab = static_cast<const SecdedTables*>(tables);
  const cudaStream_t s = cudaStream_t(stream);
  const size_t smem = decode_smem_bytes(K8);
  if (M <= kDecodeMaxM && smem <= kDecodeMaxSmem) {
    if (K8 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
      launch_decode<true>(xf, lo_, hi_, chk_, scale_, out_, tab, M, K8, N, smem, s);
    else
      launch_decode<false>(xf, lo_, hi_, chk_, scale_, out_, tab, M, K8, N, smem, s);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    ecc_matmul_kernel<<<grid, kThreads, 0, s>>>(xf, lo_, hi_, chk_, scale_, out_, tab, M,
                                                K8, N);
  }
  return int(cudaGetLastError());
}
