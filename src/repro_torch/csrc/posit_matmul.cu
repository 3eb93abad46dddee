// K6 posit_matmul: [M, K] posit codes x [K, N] posit codes -> f32 (or one
// encode into an output posit format), decoded in the kernel.
//
// Replaces src/repro/kernels/posit_matmul.py:168 posit_matmul (its
// pl.pallas_call at :205, _fused_matmul_kernel).  The TPU kernel walks a
// (M/bm, N/bn, K/bk) grid with K in order, decodes each code tile on the
// VPU, accumulates on the MXU in an f32 VMEM scratch and encodes once on
// the last K step.  Hopper blocks run in no order, so K is split here.
//
// Bound on an H100: at decode (M <= 8 rows: the slots of a decode step)
// every weight code is read once, 2 bytes, and used M times, so HBM bytes
// bound the call: one command-r-35b layer's 7 projections are 704.6 M
// codes, 1.41 GB, 0.42 ms at 3.35 TB/s.  The decode is the other limit:
// about 20 integer operations a code at the card's 64 integer lanes per
// SM is some 0.9 ms for that layer, so at M <= 8 the design's aim is to
// spend no more than that decode and to keep every SM fed.
//
// M <= 8, the split-K GEMV (posit_matmul_gemv_kernel, then
// posit_matmul_reduce_kernel):
//   * a block owns 256 columns (32 lanes x 8 codes) and one K split of KS
//     rows; its 8 warps take the split's rows in turn.  Each thread reads
//     8 weight codes of a row with one 16-byte load (8 bytes for int8
//     codes), 4 rows in flight, decodes them in registers and issues
//     8 x M FMAs against the M activation values of that row, which every
//     lane of the warp reads from shared memory as one broadcast;
//   * the block decodes its K slice of the M activation rows once into
//     shared memory, before the loop (never per column tile or K step);
//   * P(16,2) weights in int16 (every a13 projection) decode through
//     posit_decode_fast<16, 2> (posit.cuh: bit for bit posit_decode in
//     about 20 operations); other formats through the run-time decode;
//   * the split count (the wrapper's `split_k`) gives about 4 blocks per
//     SM even at N 1024 (4 column tiles x 128 splits of 64 rows).  Each
//     block sums its 8 warps' partial rows in warp order into an [S, M, N]
//     f32 scratch that the wrapper allocates; posit_matmul_reduce_kernel
//     adds the S partials in split order and writes f32 or encodes
//     fmt_out once.
//     No float atomics: two calls on the same inputs are bitwise equal.
// M > 8 (a13 prefill, M = slots x chunk): posit_matmul_tiled_kernel, one
// BM x BN output tile per block looping over K, a BM x BK tile of A and a
// BK x BN tile of B decoded once per tile load into shared memory, TM x TN
// outputs per thread in f32 registers, one encode at the end.
// Edges are bounds-checked (out-of-range codes count as 0.0), so no
// operand is padded on the host.
//
// Numerics: a P(13,2) x P(16,2) product has at most 9 + 12 significand
// bits, so every product is exact in f32 and FMA equals multiply-then-add;
// only the order of the K-long f32 sum differs from the plain version
// (held to posit_matmul.sum_bound).  Tensor cores are not used: at M <= 8
// the decode, not the arithmetic, bounds the call; one TF32 or bf16 MMA
// would round the P(16,2) operand, and an exact form (two bf16 terms per
// operand, four MMAs) is left for the M > 8 path.
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

// ---- M <= 8: split-K GEMV --------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kCols = 8;               // weight codes a thread reads per row
constexpr int kGemvBN = 32 * kCols;    // columns per block
constexpr int kUnroll = 4;             // rows in flight per thread

struct DecodeRuntime {
  int n, es;
  __device__ __forceinline__ float operator()(uint32_t c) const {
    return posit_decode(c, n, es);
  }
};

struct DecodeP16_2 {
  __device__ __forceinline__ float operator()(uint32_t c) const {
    return posit_decode_fast<16, 2>(c);
  }
};

// kCols consecutive codes of one weight row as raw words; code(j) leaves
// the code in the low bits (both decoders ignore the bits above n).
template <typename BT>
struct Row8;

template <>
struct Row8<int16_t> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const int16_t* __restrict__ p,
                                       int ncols, bool vec) {
    if (vec && ncols >= kCols) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < ncols ? (uint16_t)p[2 * i] : 0u;
      const uint32_t hi = 2 * i + 1 < ncols ? (uint16_t)p[2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
  }
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  __device__ __forceinline__ uint32_t code(int j) const {
    return (j & 1) ? w[j >> 1] >> 16 : w[j >> 1];
  }
};

template <>
struct Row8<int8_t> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const int8_t* __restrict__ p,
                                       int ncols, bool vec) {
    if (vec && ncols >= kCols) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
      return;
    }
    w[0] = w[1] = 0u;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < ncols) w[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
  }
  __device__ __forceinline__ void zero() { w[0] = w[1] = 0u; }
  __device__ __forceinline__ uint32_t code(int j) const {
    return w[j >> 2] >> (8 * (j & 3));
  }
};

__device__ __forceinline__ uint32_t act_code(const void* a, int a_bytes,
                                             size_t i) {
  return a_bytes == 2 ? (uint32_t)(int)static_cast<const int16_t*>(a)[i]
                      : (uint32_t)(int)static_cast<const int8_t*>(a)[i];
}

// One (256-column tile, K split): writes the split's [M, 256] partial
// sums into partial[split].  MR >= M rows of accumulators (a power of 2).
template <int MR, typename BT, typename Dec>
__global__ void __launch_bounds__(kGemvThreads) posit_matmul_gemv_kernel(
    const void* __restrict__ a, int a_bytes, int na, int esa,
    const BT* __restrict__ b, Dec dec, float* __restrict__ partial, int M,
    int N, int K, int KS, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * kGemvBN;
  const int split = blockIdx.y;
  const int k0 = split * KS;
  const int nk = min(K - k0, KS);

  // the split's activation rows, decoded once: As[kk * MR + m]
  for (int i = threadIdx.x; i < nk * MR; i += kGemvThreads) {
    const int kk = i / MR, m = i % MR;
    const size_t idx = (size_t)m * K + k0 + kk;
    smem[i] = m < M ? posit_decode(act_code(a, a_bytes, idx), na, esa) : 0.0f;
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

  for (int r0 = warp; r0 < nk; r0 += kGemvWarps * kUnroll) {
    Row8<BT> rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kGemvWarps;
      if (r < nk && ncols > 0)
        rows[u].load(b + (size_t)(k0 + r) * N + col, ncols, vec != 0);
      else
        rows[u].zero();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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

// out[i] = sum of the S partials in split order, then f32 or one encode.
__global__ void posit_matmul_reduce_kernel(const float* __restrict__ partial,
                                           int S, int MN,
                                           float* __restrict__ out_f32,
                                           void* __restrict__ out_codes,
                                           int no, int eso, int out_bytes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float sum = partial[i];
  for (int s = 1; s < S; ++s) sum += partial[(size_t)s * MN + i];
  if (out_f32 != nullptr) {
    out_f32[i] = sum;
  } else if (out_bytes == 1) {
    static_cast<int8_t*>(out_codes)[i] = (int8_t)posit_encode(sum, no, eso);
  } else {
    static_cast<int16_t*>(out_codes)[i] = (int16_t)posit_encode(sum, no, eso);
  }
}

size_t gemv_smem_bytes(int MR, int KS) {
  const size_t act = (size_t)KS * MR, red = (size_t)kGemvWarps * MR * kGemvBN;
  return sizeof(float) * (act > red ? act : red);
}

template <int MR, typename BT, typename Dec>
int launch_gemv(const void* a, int a_bytes, int na, int esa, const void* b,
                Dec dec, float* partial, float* out_f32, void* out_codes,
                int M, int N, int K, int KS, int S, int no, int eso,
                int out_bytes, cudaStream_t s) {
  const size_t smem = gemv_smem_bytes(MR, KS);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        posit_matmul_gemv_kernel<MR, BT, Dec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // vector loads need every row's 8-code groups aligned
  const int vec = N % kCols == 0 &&
                  reinterpret_cast<uintptr_t>(b) % (kCols * sizeof(BT)) == 0;
  dim3 grid((N + kGemvBN - 1) / kGemvBN, S);
  posit_matmul_gemv_kernel<MR, BT, Dec><<<grid, kGemvThreads, smem, s>>>(
      a, a_bytes, na, esa, (const BT*)b, dec, partial, M, N, K, KS, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int MN = M * N;
  posit_matmul_reduce_kernel<<<(MN + 255) / 256, 256, 0, s>>>(
      partial, S, MN, out_f32, out_codes, no, eso, out_bytes);
  return (int)cudaGetLastError();
}

template <typename BT, typename Dec>
int launch_gemv_rows(int M, const void* a, int a_bytes, int na, int esa,
                     const void* b, Dec dec, float* partial, float* out_f32,
                     void* out_codes, int N, int K, int KS, int S, int no,
                     int eso, int out_bytes, cudaStream_t s) {
#define K6_GEMV(MR)                                                          \
  return launch_gemv<MR, BT, Dec>(a, a_bytes, na, esa, b, dec, partial,     \
                                  out_f32, out_codes, M, N, K, KS, S, no,    \
                                  eso, out_bytes, s)
  if (M <= 1) K6_GEMV(1);
  if (M <= 2) K6_GEMV(2);
  if (M <= 4) K6_GEMV(4);
  if (M <= 8) K6_GEMV(8);
#undef K6_GEMV
  return (int)cudaErrorInvalidValue;
}

// ---- M > 8: output tiles ---------------------------------------------------

template <int BM, int BN, int BK, int TM, int TN, typename AT, typename BT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    posit_matmul_tiled_kernel(
    const AT* __restrict__ a, const BT* __restrict__ b,
    float* __restrict__ out_f32, void* __restrict__ out_codes, int M, int N,
    int K, int na, int esa, int nb, int esb, int no, int eso,
    int out_bytes) {
  constexpr int TX = BN / TN;          // threads along N
  constexpr int NT = (BM / TM) * TX;   // threads per block
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K)
                       ? posit_decode((uint32_t)(int)a[(size_t)gm * K + gk],
                                      na, esa)
                       : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N)
                       ? posit_decode((uint32_t)(int)b[(size_t)gk * N + gn],
                                      nb, esb)
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], br[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ar[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) br[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      if (out_f32 != nullptr) {
        out_f32[o] = acc[i][j];
      } else if (out_bytes == 1) {
        static_cast<int8_t*>(out_codes)[o] = (int8_t)posit_encode(acc[i][j], no, eso);
      } else {
        static_cast<int16_t*>(out_codes)[o] = (int16_t)posit_encode(acc[i][j], no, eso);
      }
    }
  }
}

template <typename AT, typename BT>
int launch_tiled(const void* a, const void* b, float* out_f32, void* out_codes,
                 int M, int N, int K, int na, int esa, int nb, int esb, int no,
                 int eso, int out_bytes, cudaStream_t s) {
  constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  posit_matmul_tiled_kernel<BM, BN, BK, TM, TN, AT, BT>
      <<<grid, (BM / TM) * (BN / TN), 0, s>>>(
          (const AT*)a, (const BT*)b, out_f32, out_codes, M, N, K, na, esa,
          nb, esb, no, eso, out_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// a_bytes / b_bytes: code container width of A and B (1 = int8, 2 = int16).
// out_f32 non-null returns f32; otherwise codes of (no, eso) are written
// to out_codes in a container of out_bytes.  variant (the wrapper's
// `matmul_variant`): 0 = tiled (any M), 1 = split-K GEMV with the run-time
// decode (M <= 8), 2 = split-K GEMV with the P(16,2) decode (M <= 8, int16
// P(16,2) weights).  The GEMV takes KS rows per split, S splits, and an
// [S, M, N] f32 scratch `partial`.
extern "C" int posit_matmul_launch(const void* a, const void* b,
                                   void* out_f32, void* out_codes,
                                   void* partial, int M, int N, int K,
                                   int a_bytes, int na, int esa, int b_bytes,
                                   int nb, int esb, int out_bytes, int no,
                                   int eso, int variant, int KS, int S,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* of = (float*)out_f32;
  float* pp = (float*)partial;
  if (a_bytes != 1 && a_bytes != 2) return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    if (b_bytes != 2 || nb != 16 || esb != 2) return (int)cudaErrorInvalidValue;
    return launch_gemv_rows<int16_t>(M, a, a_bytes, na, esa, b, DecodeP16_2{},
                                     pp, of, out_codes, N, K, KS, S, no, eso,
                                     out_bytes, s);
  }
  if (variant == 1) {
    const DecodeRuntime dec{nb, esb};
    if (b_bytes == 2)
      return launch_gemv_rows<int16_t>(M, a, a_bytes, na, esa, b, dec, pp, of,
                                       out_codes, N, K, KS, S, no, eso,
                                       out_bytes, s);
    if (b_bytes == 1)
      return launch_gemv_rows<int8_t>(M, a, a_bytes, na, esa, b, dec, pp, of,
                                      out_codes, N, K, KS, S, no, eso,
                                      out_bytes, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (a_bytes == 2 && b_bytes == 2)
    return launch_tiled<int16_t, int16_t>(a, b, of, out_codes, M, N, K, na,
                                          esa, nb, esb, no, eso, out_bytes, s);
  if (a_bytes == 1 && b_bytes == 2)
    return launch_tiled<int8_t, int16_t>(a, b, of, out_codes, M, N, K, na, esa,
                                         nb, esb, no, eso, out_bytes, s);
  if (a_bytes == 2 && b_bytes == 1)
    return launch_tiled<int16_t, int8_t>(a, b, of, out_codes, M, N, K, na, esa,
                                         nb, esb, no, eso, out_bytes, s);
  if (a_bytes == 1 && b_bytes == 1)
    return launch_tiled<int8_t, int8_t>(a, b, of, out_codes, M, N, K, na, esa,
                                        nb, esb, no, eso, out_bytes, s);
  return (int)cudaErrorInvalidValue;
}
