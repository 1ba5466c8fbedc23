// Fused SECDED decode + int8 dequant + matmul: the ECC read path of every
// protected weight matrix, out[m, n] = scale[n] * sum_k x[m, k] * W[k, n].
//
// Replaces the TPU kernel ecc_matmul_2d of src/repro/kernels/ecc_matmul.py
// (body _matmul_kernel), including the scale multiply its wrapper
// ops.ecc_matmul applies. W is stored as Hsiao (K/8, N) planes: codeword i of
// column n holds the int8 weights W[j*K/8 + i, n], byte j of the 64-bit word
// (bytes 0-3 in lo, 4-7 in hi). The TPU wrapper permutes x to match
// (ops.permute_k); here x is read in its natural layout and the 8i+j
// interleave is folded into the shared-memory tile index instead.
//
// Bound on the H100: at decode (M = batch of a few rows) bytes, the planes
// at 9/8 B per weight; at prefill (M >= ~64) the 2*M*K*N float32
// multiply-adds, which this kernel issues as FFMA against the 67 TFLOP/s
// float32 peak. Design: one block per 32 x 64 output tile, a loop over K in
// steps of 8 codeword rows (64 K values). Each step decodes its 512 plane
// words once (syndrome from the shared-memory tables, single-bit
// correction), sign-extends the 8 bytes of each word into a float tile in
// shared memory, stages the matching 32 x 64 x-tile, and every thread
// accumulates a 2 x 4 sub-tile in registers. Tensor cores, TMA and wgmma
// are later work. Sums run in another order than the plain version, so the
// results agree within 1e-4 * max|plain|, not bit for bit.
#include "secded.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK8 = 8;   // codeword rows per K step
constexpr int kBK = 8 * kBK8;

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
    // Decode this step's plane words; tile row j*kBK8 + ii holds byte j of
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
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a0 = xs[2 * ty][kk], a1 = xs[2 * ty + 1][kk];
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      acc[0][0] += a0 * b.x; acc[0][1] += a0 * b.y; acc[0][2] += a0 * b.z; acc[0][3] += a0 * b.w;
      acc[1][0] += a1 * b.x; acc[1][1] += a1 * b.y; acc[1][2] += a1 * b.z; acc[1][3] += a1 * b.w;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + 2 * ty + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (n < N) out[(long long)m * N + n] = acc[r][c] * scale[n];
    }
  }
}

}  // namespace

extern "C" int ecc_matmul(const void* x, const void* lo, const void* hi, const void* chk,
                          const void* scale, void* out, const void* tables, int M, int K8,
                          int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ecc_matmul_kernel<<<grid, kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(hi), static_cast<const uint8_t*>(chk),
      static_cast<const float*>(scale), static_cast<float*>(out),
      static_cast<const SecdedTables*>(tables), M, K8, N);
  return int(cudaGetLastError());
}
