// K9 posit_matmul_grouped: per-expert [E, M, K] x [E, K, N] -> [E, M, N],
// the weights posit codes decoded in the kernel; the activations f32
// values or posit codes; f32 out, or one encode into an output format.
//
// Replaces src/repro/kernels/posit_matmul.py:posit_matmul_grouped
// (_grouped_matmul_kernel).  The TPU kernel walks an (E, M/bm, N/bn, K/bk)
// grid, K in order, decoding each code tile on the VPU and accumulating on
// the MXU in an f32 VMEM scratch per expert, one encode at the last K step.
//
// At serving shapes M is the expert capacity (8 rows) and a decode step
// routes 4 slots x top-8 to at most 32 of 128 experts: every other
// expert's rows are zeros.  Each weight code is 2 bytes used by at most 8
// rows, so the routed experts' code bytes bound the call, and the decode
// (about 17 integer operations a code with the compile-time P(16,2)
// decode, some 30 with the run-time one) is the other limit on the SMs'
// integer pipes.  The design:
//   * a pre-pass (grouped_rows_kernel, one block per expert) writes
//     rows[e], one past the last row of expert e holding a non-zero
//     activation (a code other than 0, a float other than +-0).  A block of
//     the GEMV whose 8-row tile starts at or past rows[e] exits at once, so
//     the codes of experts no token was routed to are never read.  The
//     grid's size depends on the shapes alone (the call can be captured in
//     a CUDA graph); which blocks work depends on the data;
//   * the GEMV (grouped_gemv_kernel) is K6's split-K GEMV per expert: a
//     block owns (expert, 8-row tile, 256 columns, one K split of KS rows);
//     each thread reads 8 weight codes of a row in one 16-byte load (8
//     bytes for int8 codes), 4 rows in flight, decodes them in registers
//     (code_rows.cuh: DecodeP16_2 for int16 P(16,2) weights, the wrapper's
//     "p16_2" variant; DecodeRuntime otherwise, "posit") and issues 8 x 8
//     FMAs against the tile's activation rows, which the block decodes once
//     into shared memory and every lane of a warp reads as one broadcast;
//   * the split count (the wrapper's `grouped_split_k`, a function of
//     (M, N, K) alone) gives some 24 blocks to each occupied expert, so 32
//     routed experts fill the 132 SMs.  Each block sums its 8 warps in warp
//     order into an [S, E, M, N] f32 scratch; grouped_reduce_kernel adds
//     the S partials in split order, writes +0.0 (code 0 under fmt_out) for
//     rows at or past rows[e], and writes f32 or encodes once.  No float
//     atomics: two calls are bitwise equal, and an expert's output does not
//     depend on the other experts' rows.
// A skipped row equals the plain version's (zero activations times the
// weights) wherever no weight code of the expert is NaR; packing never
// writes NaR (posit_encode saturates finite values).
//
// Numerics: decoded codes are exact in f32 and so are the products of a
// P(16,2) weight with a P(13,2) code; a float activation's product rounds
// once in the FMA, as in any f32 GEMM.  Only the order of the K-long sum
// differs from the plain version (torch.matmul), so the kernel is held to
// posit_matmul.sum_bound.  Tensor cores are not used: TF32 would round
// the P(16,2) weights, and at 8 rows the decode, not the FMAs, bounds it.
#include <cuda_runtime.h>

#include <cstdint>

#include "code_rows.cuh"
#include "posit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 32 * kCols;  // columns per block
constexpr int kBM = 8;           // activation rows per block
constexpr int kUnroll = 4;       // weight rows in flight per thread

template <typename AT>
__device__ __forceinline__ bool nonzero(AT v) {
  return v != 0;
}
template <>
__device__ __forceinline__ bool nonzero<float>(float v) {
  return v != 0.0f;  // -0.0 counts as zero; nan as non-zero
}

template <typename AT>
__device__ __forceinline__ float act_value(AT v, int na, int esa) {
  return posit_decode((uint32_t)(int)v, na, esa);
}
template <>
__device__ __forceinline__ float act_value<float>(float v, int, int) {
  return v;
}

// rows[e] = 1 + the last row of expert e with a non-zero activation (0 if
// none); one block per expert.
template <typename AT>
__global__ void __launch_bounds__(kThreads) grouped_rows_kernel(
    const AT* __restrict__ a, int M, int K, int* __restrict__ rows) {
  __shared__ int last;
  if (threadIdx.x == 0) last = 0;
  __syncthreads();
  const AT* ae = a + (size_t)blockIdx.x * M * K;
  int mine = 0;
  for (int m = 0; m < M; ++m)
    for (int k = threadIdx.x; k < K; k += kThreads)
      if (nonzero<AT>(ae[(size_t)m * K + k])) mine = m + 1;
  for (int off = 16; off > 0; off >>= 1)
    mine = max(mine, __shfl_xor_sync(0xffffffffu, mine, off));
  if ((threadIdx.x & 31) == 0 && mine > 0) atomicMax(&last, mine);
  __syncthreads();
  if (threadIdx.x == 0) rows[blockIdx.x] = last;
}

// One (expert, 8-row tile, 256-column tile, K split): the split's partial
// sums of the tile's occupied rows into partial[split][e].
template <typename AT, typename BT, typename Dec>
__global__ void __launch_bounds__(kThreads) grouped_gemv_kernel(
    const AT* __restrict__ a, int na, int esa, const BT* __restrict__ b,
    Dec dec, const int* __restrict__ rows, float* __restrict__ partial,
    int E, int M, int N, int K, int KS, int vec) {
  const int mtiles = (M + kBM - 1) / kBM;
  const int e = blockIdx.z / mtiles;
  const int m0 = (blockIdx.z % mtiles) * kBM;
  const int used = rows[e];
  if (m0 >= used) return;  // no token in this tile: nothing to read
  const int mr = min(kBM, used - m0);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int k0 = split * KS;
  const int nk = min(K - k0, KS);
  const AT* ae = a + ((size_t)e * M + m0) * K;
  const BT* be = b + (size_t)e * K * N;

  // the tile's activation rows of the split, decoded once: As[kk * 8 + m]
  for (int i = threadIdx.x; i < nk * kBM; i += kThreads) {
    const int kk = i / kBM, m = i % kBM;
    smem[i] = m < mr ? act_value<AT>(ae[(size_t)m * K + k0 + kk], na, esa)
                     : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + lane * kCols;
  const int ncols = N - col;
  float acc[kBM][kCols];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.0f;

  for (int r0 = warp; r0 < nk; r0 += kWarps * kUnroll) {
    Row8<BT> w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kWarps;
      if (r < nk && ncols > 0)
        w[u].load(be + (size_t)(k0 + r) * N + col, ncols, vec != 0);
      else
        w[u].zero();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kWarps;
      if (r < nk) {
        float av[kBM];
#pragma unroll
        for (int m = 0; m < kBM; ++m) av[m] = smem[r * kBM + m];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float bv = dec(w[u].code(j));
#pragma unroll
          for (int m = 0; m < kBM; ++m) acc[m][j] = fmaf(av[m], bv, acc[m][j]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the activation rows

  // red[(warp * 8 + m) * 256 + c]: each warp's partial row sums
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
    float4* dst = reinterpret_cast<float4*>(
        smem + (warp * kBM + m) * kBN + lane * kCols);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  float* out = partial + (((size_t)split * E + e) * M + m0) * N;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    if (m >= mr || n0 + c >= N) continue;
    float sum = smem[m * kBN + c];
    for (int w = 1; w < kWarps; ++w) sum += smem[(w * kBM + m) * kBN + c];
    out[(size_t)m * N + n0 + c] = sum;
  }
}

// out[e, m, n] = the S partials in split order for m < rows[e], else +0.0;
// then f32 or one encode.
__global__ void grouped_reduce_kernel(const float* __restrict__ partial,
                                      const int* __restrict__ rows, int S,
                                      int M, int N, size_t EMN,
                                      float* __restrict__ out_f32,
                                      void* __restrict__ out_codes, int no,
                                      int eso, int out_bytes) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= EMN) return;
  const size_t MN = (size_t)M * N;
  const int e = (int)(i / MN);
  const int m = (int)((i % MN) / N);
  float sum = 0.0f;
  if (m < rows[e]) {
    sum = partial[i];
    for (int s = 1; s < S; ++s) sum += partial[(size_t)s * EMN + i];
  }
  if (out_f32 != nullptr) {
    out_f32[i] = sum;
  } else if (out_bytes == 1) {
    static_cast<int8_t*>(out_codes)[i] = (int8_t)posit_encode(sum, no, eso);
  } else {
    static_cast<int16_t*>(out_codes)[i] = (int16_t)posit_encode(sum, no, eso);
  }
}

size_t smem_bytes(int KS) {
  const size_t act = (size_t)KS * kBM, red = (size_t)kWarps * kBM * kBN;
  return sizeof(float) * (act > red ? act : red);
}

template <typename AT, typename BT, typename Dec>
int launch(const void* a, int na, int esa, const void* b, Dec dec, int* rows,
           float* partial, float* out_f32, void* out_codes, int E, int M,
           int N, int K, int KS, int S, int no, int eso, int out_bytes,
           cudaStream_t s) {
  const int mtiles = (M + kBM - 1) / kBM;
  if ((long long)E * mtiles > 65535 || S > 65535 || KS < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(KS);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_gemv_kernel<AT, BT, Dec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  grouped_rows_kernel<AT><<<E, kThreads, 0, s>>>((const AT*)a, M, K, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // vector loads need every row's 8-code groups aligned
  const int vec = N % kCols == 0 &&
                  reinterpret_cast<uintptr_t>(b) % (kCols * sizeof(BT)) == 0;
  dim3 grid((N + kBN - 1) / kBN, S, E * mtiles);
  grouped_gemv_kernel<AT, BT, Dec><<<grid, kThreads, smem, s>>>(
      (const AT*)a, na, esa, (const BT*)b, dec, rows, partial, E, M, N, K, KS,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t EMN = (size_t)E * M * N;
  grouped_reduce_kernel<<<(unsigned)((EMN + 255) / 256), 256, 0, s>>>(
      partial, rows, S, M, N, EMN, out_f32, out_codes, no, eso, out_bytes);
  return (int)cudaGetLastError();
}

template <typename BT, typename Dec>
int launch_a(int a_kind, const void* a, int na, int esa, const void* b,
             Dec dec, int* rows, float* partial, float* of, void* oc, int E,
             int M, int N, int K, int KS, int S, int no, int eso, int ob,
             cudaStream_t s) {
  switch (a_kind) {
    case 0: return launch<float, BT>(a, na, esa, b, dec, rows, partial, of, oc, E, M, N, K, KS, S, no, eso, ob, s);
    case 1: return launch<int8_t, BT>(a, na, esa, b, dec, rows, partial, of, oc, E, M, N, K, KS, S, no, eso, ob, s);
    case 2: return launch<int16_t, BT>(a, na, esa, b, dec, rows, partial, of, oc, E, M, N, K, KS, S, no, eso, ob, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a_kind: 0 = f32 activations, 1 = int8 codes of (na, esa), 2 = int16
// codes.  b_bytes: weight code container (1 or 2).  out_f32 non-null
// returns f32; otherwise codes of (no, eso) go to out_codes in a container
// of out_bytes.  variant (the wrapper's `grouped_variant`): 0 = the
// run-time weight decode, 1 = the P(16,2) decode (int16 P(16,2) weights).
// rows: an int32 scratch of E entries; partial: an f32 scratch of
// [S, E, M, N]; KS rows per K split, S splits (`grouped_split_k`).
extern "C" int posit_matmul_grouped_launch(
    const void* a, const void* b, void* out_f32, void* out_codes, void* rows,
    void* partial, int E, int M, int N, int K, int a_kind, int na, int esa,
    int b_bytes, int nb, int esb, int out_bytes, int no, int eso,
    int variant, int KS, int S, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* of = (float*)out_f32;
  float* pp = (float*)partial;
  int* rw = (int*)rows;
  if (variant == 1) {
    if (b_bytes != 2 || nb != 16 || esb != 2) return (int)cudaErrorInvalidValue;
    return launch_a<int16_t>(a_kind, a, na, esa, b, DecodeP16_2{}, rw, pp, of,
                             out_codes, E, M, N, K, KS, S, no, eso, out_bytes,
                             s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const DecodeRuntime dec{nb, esb};
  if (b_bytes == 2)
    return launch_a<int16_t>(a_kind, a, na, esa, b, dec, rw, pp, of,
                             out_codes, E, M, N, K, KS, S, no, eso, out_bytes,
                             s);
  if (b_bytes == 1)
    return launch_a<int8_t>(a_kind, a, na, esa, b, dec, rw, pp, of, out_codes,
                            E, M, N, K, KS, S, no, eso, out_bytes, s);
  return (int)cudaErrorInvalidValue;
}
