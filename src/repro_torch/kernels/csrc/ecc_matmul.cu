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
// call, the row invariance the exact-token checks rest on), built on one
// tensor-core instruction, mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// and written once (chunk_part below, called by both kernels):
//
// - A weight is an int8, exact in bf16. x is float32, split in registers
//   into three bf16 pieces by truncation: x0 = x & 0xFFFF0000, r = x - x0,
//   x1 = r & 0xFFFF0000, x2 = r - x1 (both subtractions exact). Each piece
//   is exact in bf16, x0 + x1 + x2 == x, and each product is exact in
//   float32: only the MMA's accumulation rounds.
// - With K8 = K/8 codeword rows cut into chunks of 8 (chunk c holds rows
//   8c..8c+7, the last padded with zero rows), a chunk is 64 K values in
//   four k16 slices: slice s holds bytes j = 2s (k = 0..7) and 2s + 1
//   (k = 8..15) of the 8 codeword rows, row 8c + (k % 8). Then
//
//     total = 0
//     for c ascending:
//       part = 0
//       for s in 0..3, for piece p in (x0, x1, x2):
//         part = mma(A = piece p of x over slice s, B = slice s of W, C = part)
//       total = __fadd_rn(total, part)
//     out[m, n] = __fmul_rn(total, scale[n])
//
//   A row of A or column of B that lies past M, N or K8 is zero in both
//   kernels. A row's result does not depend on the other rows of its
//   fragment, nor on its position inside it (tests/test_torch_gpu.py holds
//   every position 0..15 against the same row in another call).
//
// Two kernels, picked by M in the one launcher (and by K: the decode
// kernel's shared memory grows with K, past ~8,800 the tiled kernel takes
// every M):
// - M > kDecodeMaxM (prefill, speculative verify, the MLP at M = 4,000):
//   ecc_matmul_kernel. Its floor is the bf16 MMAs (3 x 2*M*K*N at 989
//   TFLOP/s) or the bytes; in practice it is bound by instruction
//   throughput: the decode of each word (8 popc), the split of each value
//   of x and the MMAs. A block of 16 warps owns a 16*kMT x 8*kNT output
//   tile (32 x 8..32, 64 x 32 or 128 x 32, picked per call so the grid
//   fills the card in one wave where it can) and walks K in rounds of
//   16/kMT chunks: warp (mt, kg) runs the
//   chain of chunk kg of the round for m16 tile mt and all its n8
//   fragments. Its A fragments come straight from global memory into
//   registers, a round ahead (no other warp reads them); the block decodes
//   each plane word of its tile once (syndrome from masks in registers,
//   single-bit correction from the flip tables, read only for a nonzero
//   syndrome) into bf16 B fragments in shared memory, in lane order, while
//   the round's MMAs run; the chunk partials go to shared memory and every
//   thread folds its outputs' partials in ascending chunk order, one
//   barrier a round.
// - M <= kDecodeMaxM (decode, the draft model, the serve lanes):
//   ecc_matmul_decode_kernel, bound by the bytes of the planes (9/8 B per
//   weight), in practice by latency. A block of 512 threads owns 8 output
//   columns (n8) and all of K (128-384 blocks at qwen3-0.6b widths). It
//   copies its activations into shared memory (cp.async, rows in groups of
//   4 in the chunk layout) while its threads load, correct and store the
//   block's (K/8, 8) plane words; then each warp runs the chunk chain of
//   its chunks for the group's rows (fragment rows 0-3, the rest zero) and
//   writes the partials to shared memory; one thread per (row, column)
//   folds them in ascending chunk order.
//
// wgmma, TMA and warp specialisation are later work. Sums run in another
// order than the plain version, so the results agree with it within
// 1e-4 * max|plain|, not bit for bit.
#include "codec.cuh"

namespace {

constexpr int kBK8 = 8;          // codeword rows per chunk
constexpr int kBK = 8 * kBK8;    // K values per chunk

// Tiled kernel.
constexpr int kThreads = 512;
constexpr int kFillBlocks = 128;  // grid size that fills the card's 132 SMs

// Decode kernel.
constexpr int kDecodeMaxM = 16;  // largest M it takes
constexpr int kDThreads = 512;
constexpr int kDWarps = kDThreads / 32;
constexpr int kDCols = 8;        // output columns per block (one n8)
constexpr int kDRows = 4;        // activation rows staged at a time
constexpr int kDBatch = 4;       // words a thread loads at once
// Dynamic shared memory a block may take beside the tables (227 KB in all);
// a larger K (K8 above ~1,100) goes to the tiled kernel.
constexpr size_t kDecodeMaxSmem = 232448 - sizeof(SecdedTables);

// ---------------------------------------------------------------- the order

// d += a * b on the tensor cores: one m16n8k16 bf16 MMA, float32 C/D.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three exact bf16 pieces of (v0, v1), each packed as a bf16x2 (v0 in
// the low half).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const uint32_t u0 = __float_as_uint(v0), u1 = __float_as_uint(v1);
  const float r0 = __fsub_rn(v0, __uint_as_float(u0 & 0xFFFF0000u));
  const float r1 = __fsub_rn(v1, __uint_as_float(u1 & 0xFFFF0000u));
  const float l0 = __fsub_rn(r0, __uint_as_float(__float_as_uint(r0) & 0xFFFF0000u));
  const float l1 = __fsub_rn(r1, __uint_as_float(__float_as_uint(r1) & 0xFFFF0000u));
  p0 = __byte_perm(u0, u1, 0x7632);
  p1 = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
  p2 = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// The A pieces of slice s for lane (g, t) from a staged row: xa points at
// the chunk's 64 values of row g (chunk layout: value 8j + ii is byte j of
// codeword row ii), null for a zero row; row g + 8 is zero. a[p][q] is
// register q of piece p.
__device__ __forceinline__ void load_a(const float* xa, int s, int t, uint32_t (&a)[3][4]) {
  float2 v[4] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f), make_float2(0.f, 0.f),
                 make_float2(0.f, 0.f)};
  if (xa) {
    v[0] = *reinterpret_cast<const float2*>(xa + 16 * s + 2 * t);
    v[2] = *reinterpret_cast<const float2*>(xa + 16 * s + 8 + 2 * t);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) split3(v[q].x, v[q].y, a[0][q], a[1][q], a[2][q]);
}

// Byte j of w as an exact float: (byte ^ 0x80) in the low mantissa bits of
// 2^23, less 2^23 + 128 (one PRMT and one FADD; I2F runs at a quarter rate).
__device__ __forceinline__ float int8_to_float(uint32_t w_x80, int j) {
  return __fsub_rn(__int_as_float(int(__byte_perm(w_x80, 0x4B000000u, 0x7540u + j))),
                   8388736.f);
}

// Byte j of words w0 and w1 (held with bytes ^ 0x80) as a bf16x2, w0 in the
// low half (exact: an int8 has 8 significant bits).
__device__ __forceinline__ uint32_t bf16x2_of_bytes(uint32_t w0, uint32_t w1, int j) {
  return __byte_perm(__float_as_uint(int8_to_float(w0, j)),
                     __float_as_uint(int8_to_float(w1, j)), 0x7632);
}

// The B fragment of slice s for lane (g, t), from its two corrected words
// (bytes ^ 0x80): codeword rows 8c + 2t (w0) and 8c + 2t + 1 (w1) of column
// g. Register 0 holds byte 2s of both, register 1 byte 2s + 1.
__device__ __forceinline__ uint2 b_frag(uint2 w0, uint2 w1, int s) {
  const uint32_t a = s < 2 ? w0.x : w0.y, b = s < 2 ? w1.x : w1.y;
  const int j = 2 * (s & 1);
  return make_uint2(bf16x2_of_bytes(a, b, j), bf16x2_of_bytes(a, b, j + 1));
}

// The chunk chain, the one written sum order of both kernels, for kNF n8
// fragments of one m16 tile: part = 0, then for s ascending, for the pieces
// x0, x1, x2: part = mma(piece, slice s, part). The fragments' chains are
// independent and run interleaved. a_of(s, a) gives the three A pieces
// of slice s, b_of(s, f) the B fragment of slice s and fragment f.
template <int kNF, class AOf, class BOf>
__device__ __forceinline__ void chunk_part(AOf&& a_of, BOf&& b_of, float (&part)[kNF][4]) {
#pragma unroll
  for (int f = 0; f < kNF; ++f) part[f][0] = part[f][1] = part[f][2] = part[f][3] = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t a[3][4], b[kNF][2];
    a_of(s, a);
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      const uint2 bq = b_of(s, f);
      b[f][0] = bq.x;
      b[f][1] = bq.y;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int f = 0; f < kNF; ++f) mma_bf16(part[f], a[p], b[f]);
  }
}

// ---------------------------------------------------------------- staging

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

// ---------------------------------------------------------------- tiled

// Dynamic shared memory of the tiled kernel, with kKG = 16/kMT chunks per
// round: two stages of B fragments ([kKG][kNT fragments][2 slice pairs][32
// lanes] uint4) and two of chunk partials ([kKG][kMT m16 tiles][kNT][32
// lanes] float4).
template <int kMT, int kNT>
constexpr size_t tiled_smem_bytes() {
  return size_t(2) * (kThreads / 32 / kMT) * kNT * (64 + kMT * 32) * 16;
}

// 16 warps: warp (mt, kg) owns m16 tile mt and all kNT n8 fragments of the
// block's 16*kMT x 8*kNT tile, and runs chunk kKG*r + kg of round r. Its A
// fragments come straight from global memory into registers (no other warp
// reads them); the block's words are decoded once per round into B
// fragments in shared memory, shared by the kMT warps of a chunk; each
// thread folds its outputs' partials of the round in ascending chunk order.
// kVec: K8 is even and x 8-byte aligned, so A pairs move as float2.
template <int kMT, int kNT, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) ecc_matmul_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ hi, const uint8_t* __restrict__ chk,
    const float* __restrict__ scale, float* __restrict__ out,
    const SecdedTables* __restrict__ gtab, int M, int K8, int N) {
  constexpr int kKG = kThreads / 32 / kMT;       // chunks per round
  constexpr int kBM = 16 * kMT, kBN = 8 * kNT, kTile = kBM * kBN;
  constexpr int kPairs = kKG * kNT * 32;         // word pairs per round (one per B lane)
  constexpr int kBU = (kPairs + kThreads - 1) / kThreads;
  constexpr int kOuts = (kTile + kThreads - 1) / kThreads;
  constexpr int kBStage = kKG * kNT * 64;        // uint4
  constexpr int kPStage = kKG * kTile / 4;       // float4
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* bs = reinterpret_cast<uint4*>(smem);                // [2][kBStage]
  float4* ps = reinterpret_cast<float4*>(bs + 2 * kBStage);  // [2][kPStage]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % kMT, kg = warp / kMT;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_chunks = (K8 + kBK8 - 1) / kBK8, n_rounds = (n_chunks + kKG - 1) / kKG;

  // xv[s][q]: A register q of slice s of this warp's chunk in round r, rows
  // g + 8 (q % 2) of tile mt at x[m, (2s + q / 2)*K8 + 8c + 2t + {0, 1}];
  // zeros past M and K8. Offsets are 32-bit (the launcher checks M*K and
  // K8*N); rows past M read row 0 and are zeroed.
  float2 xv[4][4];
  const int row = m0 + 16 * mt + g;
  const bool row_ok[2] = {row < M, row + 8 < M};
  const int xrow[2] = {(row_ok[0] ? row : 0) * 8 * K8 + 2 * t,
                       (row_ok[1] ? row + 8 : 0) * 8 * K8 + 2 * t};
  auto load_a = [&](int r, int s) {
    const int off = kBK8 * (r * kKG + kg), i = off + 2 * t;  // codeword row of the first value
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = x + (xrow[q & 1] + (2 * s + (q >> 1)) * K8 + off);
      const bool ok = row_ok[q & 1] && i < K8;
      if (kVec) {  // i + 1 < K8 when i < K8
        xv[s][q] = ok ? __ldg(reinterpret_cast<const float2*>(src)) : make_float2(0.f, 0.f);
      } else {
        xv[s][q] = make_float2(ok ? __ldg(src) : 0.f,
                               row_ok[q & 1] && i + 1 < K8 ? __ldg(src + 1) : 0.f);
      }
    }
  };
  // Word pair p of round r is B lane p % 32 of fragment f = (p / 32) % kNT
  // of chunk kgi = p / (32 kNT): codeword rows 8c + 2t, +1 of column
  // n0 + 8f + g; zeros past K8 and N.
  uint32_t wl[kBU][2], wh[kBU][2], wc[kBU][2];
  auto load_w = [&](int r) {
#pragma unroll
    for (int k = 0; k < kBU; ++k) {
      const int p = tid + k * kThreads, pl = p & 31, f = (p >> 5) % kNT;
      const int i = kBK8 * (r * kKG + (p >> 5) / kNT) + 2 * (pl & 3);
      const int n = n0 + 8 * f + (pl >> 2);
      const bool ok = p < kPairs && n < N;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const bool okv = ok && i + v < K8;
        const int idx = (i + v) * N + n;
        wl[k][v] = okv ? __ldg(lo + idx) : 0u;
        wh[k][v] = okv ? __ldg(hi + idx) : 0u;
        wc[k][v] = okv ? __ldg(chk + idx) : 0u;
      }
    }
  };
  // The encode masks in registers (every word needs all 16: the syndrome
  // below is encode<Secded72> of codec.cuh with its masks there); the flip
  // tables are read, through the read-only path, only for the rare word
  // whose syndrome is not 0 (no table copy, and no barrier, before the
  // first round).
  uint32_t mask_lo[8], mask_hi[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    mask_lo[b] = __ldg(&gtab->mask_lo[b]);
    mask_hi[b] = __ldg(&gtab->mask_hi[b]);
  }
  // The loaded words, corrected, as the B fragments of stage buf.
  auto produce = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kBU; ++k) {
      const int p = tid + k * kThreads;
      if (p >= kPairs) break;
      uint2 w[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        uint32_t syn = wc[k][v];
#pragma unroll
        for (int b = 0; b < 8; ++b)
          syn ^= uint32_t(__popc((wl[k][v] & mask_lo[b]) ^ (wh[k][v] & mask_hi[b])) & 1) << b;
        const uint32_t flo = syn ? __ldg(&gtab->flip_lo[syn]) : 0u;
        const uint32_t fhi = syn ? __ldg(&gtab->flip_hi[syn]) : 0u;
        w[v] = make_uint2((wl[k][v] ^ flo) ^ 0x80808080u, (wh[k][v] ^ fhi) ^ 0x80808080u);
      }
      uint4* dst = bs + buf * kBStage + (p >> 5) * 64 + (p & 31);  // (kgi * kNT + f, h, lane)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2 b0 = b_frag(w[0], w[1], 2 * h), b1 = b_frag(w[0], w[1], 2 * h + 1);
        dst[32 * h] = make_uint4(b0.x, b0.y, b1.x, b1.y);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < 4; ++s) load_a(0, s);
  load_w(0);
  produce(0);
  if (n_rounds > 1) load_w(1);
  __syncthreads();
  float total[kOuts] = {};
  // Round r's partials are folded in round r + 1, after its MMAs start.
  auto fold = [&](int r) {
    const float* pf = reinterpret_cast<const float*>(ps + (r & 1) * kPStage) + tid;
    const int n_here = min(kKG, n_chunks - r * kKG);
#pragma unroll
    for (int q = 0; q < kOuts; ++q) {
      if (kTile % kThreads != 0 && tid + q * kThreads >= kTile) break;
      if (n_here == kKG) {
#pragma unroll
        for (int k = 0; k < kKG; ++k) total[q] = __fadd_rn(total[q], pf[k * kTile + q * kThreads]);
      } else {
        for (int k = 0; k < n_here; ++k) total[q] = __fadd_rn(total[q], pf[k * kTile + q * kThreads]);
      }
    }
  };
  for (int r = 0; r < n_rounds; ++r) {
    const int buf = r & 1;
    const bool mine = r * kKG + kg < n_chunks;  // this warp has a chunk this round
    const bool more = r + 1 < n_rounds;
    float part[kNT][4];
    if (mine) {
      const uint4* bq = bs + buf * kBStage + kg * kNT * 64 + lane;
      chunk_part<kNT>(
          [&](int s, uint32_t(&a)[3][4]) {
#pragma unroll
            for (int q = 0; q < 4; ++q) split3(xv[s][q].x, xv[s][q].y, a[0][q], a[1][q], a[2][q]);
            if (more) load_a(r + 1, s);  // slice s of the next round, as soon as it is free
          },
          [&](int s, int f) {
            const uint4 v = bq[(2 * f + (s >> 1)) * 32];
            return s & 1 ? make_uint2(v.z, v.w) : make_uint2(v.x, v.y);
          },
          part);
    } else if (more) {
#pragma unroll
      for (int s = 0; s < 4; ++s) load_a(r + 1, s);
    }
    if (more) {
      produce(buf ^ 1);  // round r + 1's words, while the MMAs run
      if (r + 2 < n_rounds) load_w(r + 2);
    }
    if (r > 0) fold(r - 1);
    if (mine) {
#pragma unroll
      for (int f = 0; f < kNT; ++f)
        ps[buf * kPStage + ((kg * kMT + mt) * kNT + f) * 32 + lane] =
            make_float4(part[f][0], part[f][1], part[f][2], part[f][3]);
    }
    __syncthreads();  // partials of round r and B fragments of round r + 1 in place
  }
  fold(n_rounds - 1);
  // Output e of the tile is register e % 4 of lane (e / 4) % 32 of fragment
  // (e / 128) % kNT of m16 tile e / (128 kNT).
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    const int e = tid + q * kThreads, el = (e >> 2) & 31, rr = e & 3;
    const int m = m0 + 16 * (e / (128 * kNT)) + (el >> 2) + 8 * (rr >> 1);
    const int n = n0 + 8 * ((e >> 7) % kNT) + 2 * (el & 3) + (rr & 1);
    if (e < kTile && m < M && n < N) out[(long long)m * N + n] = __fmul_rn(total[q], scale[n]);
  }
}

template <int kMT, int kNT, bool kVec>
void launch_tiled(const float* x, const uint32_t* lo, const uint32_t* hi, const uint8_t* chk,
                  const float* scale, float* out, const SecdedTables* tab, int M, int K8, int N,
                  cudaStream_t s) {
  constexpr size_t smem = tiled_smem_bytes<kMT, kNT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ecc_matmul_kernel<kMT, kNT, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  (void)attr;  // a refused attribute shows as a refused launch
  const dim3 grid((N + 8 * kNT - 1) / (8 * kNT), (M + 16 * kMT - 1) / (16 * kMT));
  ecc_matmul_kernel<kMT, kNT, kVec><<<grid, kThreads, smem, s>>>(x, lo, hi, chk, scale, out,
                                                                 tab, M, K8, N);
}

template <int kMT, int kNT>
void launch_tiled(const float* x, const uint32_t* lo, const uint32_t* hi, const uint8_t* chk,
                  const float* scale, float* out, const SecdedTables* tab, int M, int K8, int N,
                  bool vec, cudaStream_t s) {
  if (vec)
    launch_tiled<kMT, kNT, true>(x, lo, hi, chk, scale, out, tab, M, K8, N, s);
  else
    launch_tiled<kMT, kNT, false>(x, lo, hi, chk, scale, out, tab, M, K8, N, s);
}

// The tile of a call. One block runs per SM (512 threads of ~128
// registers), so a grid of more than 132 blocks runs in waves, each paying
// the round-trip latency of its first round again. The tallest tile whose
// grid still covers three quarters of the card (96 blocks) is taken: 128 or
// 64 rows (fewer decodes of each word), never taller than M; else 32 rows
// with the widest of 32, 16 and 8 columns that gives kFillBlocks blocks.
void launch_tiled_for(const float* x, const uint32_t* lo, const uint32_t* hi,
                      const uint8_t* chk, const float* scale, float* out,
                      const SecdedTables* tab, int M, int K8, int N, bool vec, cudaStream_t s) {
  const auto blocks = [&](int bm, int bn) {
    return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  };
  if (M >= 128 && blocks(128, 32) >= 96)
    launch_tiled<8, 4>(x, lo, hi, chk, scale, out, tab, M, K8, N, vec, s);
  else if (M >= 64 && blocks(64, 32) >= 96)
    launch_tiled<4, 4>(x, lo, hi, chk, scale, out, tab, M, K8, N, vec, s);
  else if (blocks(32, 32) >= kFillBlocks)
    launch_tiled<2, 4>(x, lo, hi, chk, scale, out, tab, M, K8, N, vec, s);
  else if (blocks(32, 16) >= kFillBlocks)
    launch_tiled<2, 2>(x, lo, hi, chk, scale, out, tab, M, K8, N, vec, s);
  else
    launch_tiled<2, 1>(x, lo, hi, chk, scale, out, tab, M, K8, N, vec, s);
}

// ---------------------------------------------------------------- decode

// Staged activation row stride of the decode kernel, in floats: the
// n_chunks chunk runs of 64 values and 8 of padding (bank offset per row).
__host__ __device__ inline int decode_x_stride(int n_chunks) { return n_chunks * kBK + 8; }

// Dynamic shared memory of the decode kernel: corrected words [K8p][kDCols]
// (uint2), one group of activation rows [kDRows][stride] (float, chunk
// layout), chunk sums [n_chunks][kDRows * kDCols] (float); K8p = 8 * n_chunks.
inline size_t decode_smem_bytes(int K8) {
  const size_t n_chunks = (K8 + kBK8 - 1) / kBK8;
  return n_chunks * kBK8 * kDCols * 8 + size_t(kDRows) * decode_x_stride(int(n_chunks)) * 4 +
         n_chunks * kDRows * kDCols * 4;
}

// kVec: x is 16-byte aligned and K8 % 4 == 0, so activations move in
// 16-byte copies.
template <bool kVec>
__global__ void __launch_bounds__(kDThreads, 3) ecc_matmul_decode_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ hi, const uint8_t* __restrict__ chk,
    const float* __restrict__ scale, float* __restrict__ out,
    const SecdedTables* __restrict__ gtab, int M, int K8, int N) {
  __shared__ SecdedTables tab;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n0 = blockIdx.x * kDCols;
  const int g = lane >> 2, t = lane & 3;
  const int K = 8 * K8, n_chunks = (K8 + kBK8 - 1) / kBK8, K8p = kBK8 * n_chunks;
  const int n_words = K8p * kDCols, xstride = decode_x_stride(n_chunks);
  uint2* ws = reinterpret_cast<uint2*>(smem);
  float* xs = reinterpret_cast<float*>(ws + n_words);
  float* parts = xs + kDRows * xstride;

  // Activation rows m0..m0+kDRows-1 into xs in the chunk layout (x[m, j*K8
  // + i] at (i / 8) * 64 + 8j + i % 8; zeros past M and K8), asynchronously.
  auto stage_x = [&](int m0) {
    constexpr int v = kVec ? 4 : 1;
    const int per_row = 8 * K8p / v;
    for (int e = tid; e < kDRows * per_row; e += kDThreads) {
      const int r = e / per_row, f = v * (e % per_row), j = f / K8p, i = f % K8p;
      const bool ok = m0 + r < M && i < K8;
      cp_async<4 * v>(xs + r * xstride + (i / kBK8) * kBK + 8 * j + i % kBK8,
                      ok ? x + (long long)(m0 + r) * K + (long long)j * K8 + i : x, ok);
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
    if (w0 == 0) load_shared<Secded72>(tab, gtab, tid, kDThreads);  // while the words load
#pragma unroll
    for (int b = 0; b < kDBatch; ++b) {
      const int w = w0 + b * kDThreads + tid;
      if (w < n_words) {
        const uint32_t s = encode<Secded72>(tab, rl[b], rh[b]) ^ rc[b];
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
    // Warp w runs chunks w, w + kDWarps, ...: fragment row g < kDRows is row
    // m0 + g, the other rows are zero; lane (g, t) keeps columns 2t, 2t + 1.
    for (int c = warp; c < n_chunks; c += kDWarps) {
      const float* xa = g < kDRows ? xs + g * xstride + c * kBK : nullptr;
      const uint2 w0 = ws[(kBK8 * c + 2 * t) * kDCols + g];
      const uint2 w1 = ws[(kBK8 * c + 2 * t + 1) * kDCols + g];
      float part[1][4];
      chunk_part<1>([&](int s, uint32_t(&a)[3][4]) { load_a(xa, s, t, a); },
                    [&](int s, int) { return b_frag(w0, w1, s); }, part);
      if (g < kDRows)
        *reinterpret_cast<float2*>(parts + c * (kDRows * kDCols) + g * kDCols + 2 * t) =
            make_float2(part[0][0], part[0][1]);
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

// The kernel an (M, K8) call launches: 0 the decode kernel (M <= kDecodeMaxM
// while its shared memory fits, K up to 8,832), 1 the tiled kernel.
extern "C" int ecc_matmul_kernel_for(int M, int K8) {
  return M <= kDecodeMaxM && decode_smem_bytes(K8) <= kDecodeMaxSmem ? 0 : 1;
}

// One launch per call, of the kernel ecc_matmul_kernel_for names. Both run
// the one chunk chain, so the choice (and the tile) never changes a row's
// floats.
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
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (ecc_matmul_kernel_for(M, K8) == 0) {
    const size_t smem = decode_smem_bytes(K8);
    if (K8 % 4 == 0 && xa % 16 == 0)
      launch_decode<true>(xf, lo_, hi_, chk_, scale_, out_, tab, M, K8, N, smem, s);
    else
      launch_decode<false>(xf, lo_, hi_, chk_, scale_, out_, tab, M, K8, N, smem, s);
  } else {
    if (8LL * K8 * M >= (1LL << 31) || (long long)K8 * N >= (1LL << 31))
      return int(cudaErrorInvalidValue);  // the tiled kernel's offsets are 32-bit
    launch_tiled_for(xf, lo_, hi_, chk_, scale_, out_, tab, M, K8, N,
                     K8 % 2 == 0 && xa % 8 == 0, s);
  }
  return int(cudaGetLastError());
}
