// K9 posit_matmul_grouped: per-expert [E, M, K] x [E, K, N] -> [E, M, N],
// the weights posit codes decoded in the kernel; the activations f32
// values or posit codes; f32 out, or one encode into an output format.
//
// Replaces src/repro/kernels/posit_matmul.py:posit_matmul_grouped
// (_grouped_matmul_kernel).  The TPU kernel walks an (E, M/bm, N/bn, K/bk)
// grid, K in order, decoding each code tile on the VPU and accumulating on
// the MXU in an f32 VMEM scratch per expert, one encode at the last K step.
//
// At serving shapes M is the expert capacity (8 at decode) and every step
// reads all E experts' stacks: 2 bytes per weight code, each used by M
// rows, so the weight bytes bound the call and each weight should be read
// and decoded once.  A block owns one (expert, 8-row, 512-column) tile:
// 128 threads, each with 4 adjacent columns and the 8 rows in registers
// (32 f32 accumulators).  The activation rows of a K slab sit in shared
// memory (decoded once when they are codes); each thread reads its 4
// weight codes of a K row straight from device memory (one 8-byte load
// where the row is aligned), decodes them (posit.cuh) and does 32 FMAs.
// There is no shared-memory stage for the weights and no barrier inside
// the K slab; consecutive threads read consecutive 8-byte words.
//
// Numerics: decoded codes are exact in f32 and so are the products of a
// P(16,2) weight with a P(13,2) code; a float activation's product rounds
// once in the FMA, as in any f32 GEMM.  Only the order of the K-long sum
// differs from the plain version (torch.matmul), so the kernel is held to
// posit_matmul.sum_bound.  Tensor cores are not used: TF32 would round
// the P(16,2) weights.
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

constexpr int BM = 8;          // rows per block
constexpr int CN = 4;          // adjacent columns per thread
constexpr int NT = 128;        // threads per block
constexpr int BN = NT * CN;    // columns per block
constexpr int BK = 64;         // K rows per activation slab

template <typename AT>
__device__ __forceinline__ float act_value(AT v, int na, int esa) {
  return posit_decode((uint32_t)(int)v, na, esa);
}
template <>
__device__ __forceinline__ float act_value<float>(float v, int, int) {
  return v;
}

template <typename BT>
__device__ __forceinline__ void load_codes(const BT* __restrict__ row,
                                           int col, int N, bool vec,
                                           int (&c)[CN]) {
  if (vec) {
    if constexpr (sizeof(BT) == 2) {
      const short4 w = *reinterpret_cast<const short4*>(row + col);
      c[0] = w.x; c[1] = w.y; c[2] = w.z; c[3] = w.w;
    } else {
      const char4 w = *reinterpret_cast<const char4*>(row + col);
      c[0] = w.x; c[1] = w.y; c[2] = w.z; c[3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CN; ++j) c[j] = col + j < N ? (int)row[col + j] : 0;
  }
}

template <typename AT, typename BT>
__global__ void __launch_bounds__(NT) grouped_kernel(
    const AT* __restrict__ a, const BT* __restrict__ b,
    float* __restrict__ out_f32, void* __restrict__ out_codes, int M, int N,
    int K, int na, int esa, int nb, int esb, int no, int eso,
    int out_bytes) {
  __shared__ float As[BK][BM];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int col = blockIdx.x * BN + threadIdx.x * CN;
  const AT* ae = a + (size_t)e * M * K;
  const BT* be = b + (size_t)e * K * N;
  // 8-byte (int16) / 4-byte (int8) loads need every row start aligned
  const bool vec = (N % CN == 0) && (col + CN <= N);

  float acc[BM][CN];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kt = min(BK, K - k0);
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;  // neighbours along K
      const int r = m0 + mm;
      As[kk][mm] = (r < M && kk < kt)
                       ? act_value<AT>(ae[(size_t)r * K + k0 + kk], na, esa)
                       : 0.0f;
    }
    __syncthreads();
    if (col < N) {
#pragma unroll 4
      for (int kk = 0; kk < kt; ++kk) {
        int c[CN];
        load_codes<BT>(be + (size_t)(k0 + kk) * N, col, N, vec, c);
        float w[CN];
#pragma unroll
        for (int j = 0; j < CN; ++j) w[j] = posit_decode((uint32_t)c[j], nb, esb);
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const float x = As[kk][i];
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int r = m0 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int cc = col + j;
      if (cc >= N) continue;
      const size_t o = ((size_t)e * M + r) * N + cc;
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
           int E, int M, int N, int K, int na, int esa, int nb, int esb,
           int no, int eso, int out_bytes, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  grouped_kernel<AT, BT><<<grid, NT, 0, s>>>(
      (const AT*)a, (const BT*)b, out_f32, out_codes, M, N, K, na, esa, nb,
      esb, no, eso, out_bytes);
  return (int)cudaGetLastError();
}

template <typename BT>
int launch_a(const void* a, const void* b, float* of, void* oc, int E, int M,
             int N, int K, int a_kind, int na, int esa, int nb, int esb,
             int no, int eso, int ob, cudaStream_t s) {
  switch (a_kind) {
    case 0: return launch<float, BT>(a, b, of, oc, E, M, N, K, na, esa, nb, esb, no, eso, ob, s);
    case 1: return launch<int8_t, BT>(a, b, of, oc, E, M, N, K, na, esa, nb, esb, no, eso, ob, s);
    case 2: return launch<int16_t, BT>(a, b, of, oc, E, M, N, K, na, esa, nb, esb, no, eso, ob, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a_kind: 0 = f32 activations, 1 = int8 codes of (na, esa), 2 = int16
// codes.  b_bytes: weight code container (1 or 2).  out_f32 non-null
// returns f32; otherwise codes of (no, eso) go to out_codes in a container
// of out_bytes.  Grid dimension z is the expert (E <= 65535).
extern "C" int posit_matmul_grouped_launch(
    const void* a, const void* b, void* out_f32, void* out_codes, int E,
    int M, int N, int K, int a_kind, int na, int esa, int b_bytes, int nb,
    int esb, int out_bytes, int no, int eso, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (E > 65535) return (int)cudaErrorInvalidValue;
  float* of = (float*)out_f32;
  if (b_bytes == 2)
    return launch_a<int16_t>(a, b, of, out_codes, E, M, N, K, a_kind, na, esa,
                             nb, esb, no, eso, out_bytes, s);
  if (b_bytes == 1)
    return launch_a<int8_t>(a, b, of, out_codes, E, M, N, K, a_kind, na, esa,
                            nb, esb, no, eso, out_bytes, s);
  return (int)cudaErrorInvalidValue;
}
