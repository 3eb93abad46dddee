// K6 posit_matmul: [M, K] posit codes x [K, N] posit codes -> f32 (or one
// encode into an output posit format), decoded in the kernel.
//
// Replaces src/repro/kernels/posit_matmul.py:posit_matmul
// (_fused_matmul_kernel).  The TPU kernel walks a (M/bm, N/bn, K/bk) grid
// with K in order, decodes each code tile on the VPU, accumulates on the
// MXU in an f32 VMEM scratch and encodes once on the last K step.  Here a
// block owns one BM x BN output tile and loops over K itself: it stages a
// BM x BK tile of A and a BK x BN tile of B, decoding each code once per
// tile load (posit.cuh) into shared memory, accumulates TM x TN outputs
// per thread in f32 registers with FMA across all of K, and encodes once
// when fmt_out is set.  Edges are bounds-checked (code 0 decodes to 0.0
// in the reference's padding; out-of-range elements are 0.0 here), so no
// operand is padded on the host.
//
// Numerics: a P(13,2) x P(16,2) product has at most 9 + 12 significand
// bits, so every product is exact in f32 and FMA equals multiply-then-add;
// only the order of the K-long f32 sum differs from the plain version.
// Tensor cores are not used: TF32 would round the P(16,2) operand.
//
// Bound on an H100: at decode (M = 4 slots) the weight codes dominate, 2
// bytes per weight read once, so HBM bytes bound the call (a 8192 x 8192
// weight: 0.04 ms); the in-kernel decode (some 40 integer operations per
// code) is what this simple kernel actually spends its time on.  Two tile
// shapes: BM = 4 for M <= 8 (one row block, every weight decoded once),
// BM = 64 with 4 x 4 outputs per thread otherwise.
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN, typename AT, typename BT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) posit_matmul_kernel(
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
int launch(const void* a, const void* b, float* out_f32, void* out_codes,
           int M, int N, int K, int na, int esa, int nb, int esb, int no,
           int eso, int out_bytes, cudaStream_t s) {
  if (M <= 8) {
    constexpr int BM = 4, BN = 64, BK = 32, TM = 1, TN = 1;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    posit_matmul_kernel<BM, BN, BK, TM, TN, AT, BT>
        <<<grid, (BM / TM) * (BN / TN), 0, s>>>(
            (const AT*)a, (const BT*)b, out_f32, out_codes, M, N, K, na, esa,
            nb, esb, no, eso, out_bytes);
  } else {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    posit_matmul_kernel<BM, BN, BK, TM, TN, AT, BT>
        <<<grid, (BM / TM) * (BN / TN), 0, s>>>(
            (const AT*)a, (const BT*)b, out_f32, out_codes, M, N, K, na, esa,
            nb, esb, no, eso, out_bytes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a_bytes / b_bytes: code container width of A and B (1 = int8, 2 = int16).
// out_f32 non-null returns f32; otherwise codes of (no, eso) are written
// to out_codes in a container of out_bytes.
extern "C" int posit_matmul_launch(const void* a, const void* b,
                                   void* out_f32, void* out_codes, int M,
                                   int N, int K, int a_bytes, int na, int esa,
                                   int b_bytes, int nb, int esb, int out_bytes,
                                   int no, int eso, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* of = (float*)out_f32;
  if (a_bytes == 2 && b_bytes == 2)
    return launch<int16_t, int16_t>(a, b, of, out_codes, M, N, K, na, esa, nb,
                                    esb, no, eso, out_bytes, s);
  if (a_bytes == 1 && b_bytes == 2)
    return launch<int8_t, int16_t>(a, b, of, out_codes, M, N, K, na, esa, nb,
                                   esb, no, eso, out_bytes, s);
  if (a_bytes == 2 && b_bytes == 1)
    return launch<int16_t, int8_t>(a, b, of, out_codes, M, N, K, na, esa, nb,
                                   esb, no, eso, out_bytes, s);
  if (a_bytes == 1 && b_bytes == 1)
    return launch<int8_t, int8_t>(a, b, of, out_codes, M, N, K, na, esa, nb,
                                  esb, no, eso, out_bytes, s);
  return (int)cudaErrorInvalidValue;
}
