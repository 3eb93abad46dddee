// The split-K GEMV over a [K, N] weight operand of posit codes at M <= 8
// activation rows, shared by K6 (coded activations, posit_matmul.cu) and
// the float weight path's GEMV (f32 or bf16 activations, posit_gemv_f.cu).
//
// A block owns 256 columns (32 lanes x 8 codes) and one K split of KS
// rows; its 8 warps take the split's rows in turn.  Each thread reads 8
// weight codes of a row with one 16-byte load (8 bytes for int8 codes), 4
// rows in flight, decodes them in registers (code_rows.cuh) and issues
// 8 x M FMAs against the M activation values of that row, which every
// lane of the warp reads from shared memory as one broadcast.  The block
// loads its K slice of the M activation rows once into shared memory as
// f32 (decoding codes, widening bf16: both exact), before the loop.  Each
// block sums its 8 warps' partial rows in warp order into an [S, M, N]
// f32 scratch; the caller's reduce adds the S partials in split order.
// No float atomics: two calls on the same inputs are bitwise equal.
#pragma once

#include <cstdint>

#include "code_rows.cuh"
#include "posit.cuh"

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvBN = 32 * kCols;  // columns per block
constexpr int kGemvUnroll = 4;       // weight rows in flight per thread

// Activation loaders: element i of the [M, K] activations (i = m K + k) as
// an exact f32.
struct ActCodes {  // int8 / int16 posit codes of (n, es)
  const void* a;
  int bytes, n, es;
  __device__ __forceinline__ float operator()(size_t i) const {
    const uint32_t c =
        bytes == 2 ? (uint32_t)(int)static_cast<const int16_t*>(a)[i]
                   : (uint32_t)(int)static_cast<const int8_t*>(a)[i];
    return posit_decode(c, n, es);
  }
};

struct ActF32 {
  const float* a;
  __device__ __forceinline__ float operator()(size_t i) const {
    return __ldg(a + i);
  }
};

struct ActBf16 {  // bf16 values as their bits
  const uint16_t* a;
  __device__ __forceinline__ float operator()(size_t i) const {
    return __uint_as_float((uint32_t)__ldg(a + i) << 16);
  }
};

// One (256-column tile, K split) of the block's grid position: writes the
// split's [M, 256] partial sums into partial[split].  MR >= M rows of
// accumulators (a power of 2); smem holds gemv_smem_bytes(MR, KS).
template <int MR, typename Act, typename BT, typename Dec>
__device__ __forceinline__ void gemv_split(Act act, const BT* __restrict__ b,
                                           Dec dec,
                                           float* __restrict__ partial, int M,
                                           int N, int K, int KS, int vec,
                                           float* smem) {
  const int n0 = blockIdx.x * kGemvBN;
  const int split = blockIdx.y;
  const int k0 = split * KS;
  const int nk = min(K - k0, KS);

  // the split's activation rows, once: As[kk * MR + m]
  for (int i = threadIdx.x; i < nk * MR; i += kGemvThreads) {
    const int kk = i / MR, m = i % MR;
    smem[i] = m < M ? act((size_t)m * K + k0 + kk) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + lane * kCols;
  const int ncols = N - col;
  float acc[MR][kCols];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.0f;

  for (int r0 = warp; r0 < nk; r0 += kGemvWarps * kGemvUnroll) {
    Row8<BT> rows[kGemvUnroll];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int r = r0 + u * kGemvWarps;
      if (r < nk && ncols > 0)
        rows[u].load(b + (size_t)(k0 + r) * N + col, ncols, vec != 0);
      else
        rows[u].zero();
    }
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int r = r0 + u * kGemvWarps;
      if (r < nk) {
        float av[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) av[m] = smem[r * MR + m];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float bv = dec(rows[u].code(j));
#pragma unroll
          for (int m = 0; m < MR; ++m) acc[m][j] = fmaf(av[m], bv, acc[m][j]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the activation rows

  // red[(warp * MR + m) * kGemvBN + c]: each warp's partial row sums
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float4* dst = reinterpret_cast<float4*>(
        smem + (warp * MR + m) * kGemvBN + lane * kCols);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MR * kGemvBN; i += kGemvThreads) {
    const int m = i / kGemvBN, c = i % kGemvBN;
    if (m >= M || n0 + c >= N) continue;
    float sum = smem[m * kGemvBN + c];
    for (int w = 1; w < kGemvWarps; ++w)
      sum += smem[(w * MR + m) * kGemvBN + c];
    partial[((size_t)split * M + m) * N + n0 + c] = sum;
  }
}

// shared memory of gemv_split: the split's activation rows, then the
// warps' partial rows
inline size_t gemv_smem_bytes(int MR, int KS) {
  const size_t act = (size_t)KS * MR, red = (size_t)kGemvWarps * MR * kGemvBN;
  return sizeof(float) * (act > red ? act : red);
}
