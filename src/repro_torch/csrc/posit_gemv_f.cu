// posit_gemv_f: float activations x posit-coded weights -> f32 at decode
// rows (M <= 8), each weight code decoded next to its dot: the float
// weight path's GEMV.
//
// Replaces, on the float weight path, the TPU kernel
// src/repro/kernels/posit_codec.py:55 decode (its pl.pallas_call at :66),
// whose f32 output the reference's ops.matmul_posit_weights
// (src/repro/kernels/ops.py:268) hands to jnp.dot.  Decoding the whole
// operand first moves 10 bytes a weight (2 read and 4 written by the
// decode, 4 read by the product); here every code is read once, 2 bytes.
//
// Bound on an H100: at M <= 8 each code is used at most 8 times, so HBM
// bytes bound the call: one command-r-35b layer's 7 projections are
// 704.6 M codes, 1.41 GB, 0.42 ms at 3.35 TB/s; the tied [256000, 8192]
// head 4.19 GB, 1.25 ms.  The decode is the other limit: some 17 integer
// operations a code with posit_decode_fast<16, 2> (every serving
// checkpoint's P(16,2) weights in int16), some 30 with the run-time decode
// (any other format), on 64 integer lanes an SM; so the design spends no
// more than the decode and keeps every SM fed.  Products of a float
// activation and a decoded code round once in the FMA, as in any f32
// GEMM; only the order of the K-long sums differs from torch.matmul on
// the decoded weights (held to posit_matmul.sum_bound with fmt_a None).
//
// Activations arrive as f32 or bf16 and are widened in the kernel (exact),
// so no cast kernel runs before it.  Two weight layouts:
//   * [K, N] contiguous (every projection): K6's split-K GEMV body
//     (gemv_rows.cuh) with a float activation loader.  A block owns 256
//     columns and one K split (the wrapper's `split_k`, K6's geometry);
//     each lane reads 8 codes of a row with one 16-byte load, 4 rows in
//     flight, the block's activation slice in shared memory;
//   * the transpose of a contiguous [N, K] (the tied head, [V, D] read as
//     [D, V]; no transposed copy of the codes is ever made): each
//     output's K codes are contiguous, so a warp owns an output row at a
//     time and reads 256 of its codes a step, one 16-byte load a lane (a
//     warp-load 512 contiguous bytes), 4 steps in flight.  A block owns
//     128 output rows (16 a warp) and one K split of KS codes (the
//     wrapper's `split_k_t`: 2048 at the head, fewer where few row tiles
//     leave SMs idle).  The split's activations sit in shared memory as
//     f32, permuted so that lane l's 8 values of a step are two float4
//     planes at float4 32 h + l (conflict-free).  Each lane sums its codes
//     in order, then the warp adds its 32 lanes' sums by a fixed xor
//     butterfly.
// Each K split writes its [M, N] partial sums to an [S, M, N] scratch
// (the output itself when S = 1), and posit_gemv_f_reduce_kernel adds the
// S partials in split order.  No float atomics: two calls on the same
// inputs are bitwise equal, so several calls over one weight (the
// speculative verify's tokens, each at the decode step's M) give what
// separate calls give.
#include <cuda_runtime.h>

#include <cstdint>

#include "code_rows.cuh"
#include "gemv_rows.cuh"
#include "posit.cuh"

namespace {

constexpr int kRefused = -1;          // a configuration the launcher does not take
constexpr int kTRowsPerWarp = 16;     // output rows a warp walks (transposed)
constexpr int kTRows = kGemvWarps * kTRowsPerWarp;  // output rows a block
constexpr int kTSpan = 32 * kCols;    // K codes a warp reads a step
constexpr int kTInFlight = 4;         // steps of a row in flight a lane

// [K, N] weights: the split-K GEMV body K6 runs, over float activations.
template <int MR, typename Act, typename BT, typename Dec>
__global__ void __launch_bounds__(kGemvThreads) posit_gemv_f_kernel(
    Act act, const BT* __restrict__ b, Dec dec, float* __restrict__ dst,
    int M, int N, int K, int KS, int vec) {
  extern __shared__ float4 smem4[];
  gemv_split<MR>(act, b, dec, dst, M, N, K, KS, vec,
                 reinterpret_cast<float*>(smem4));
}

// The transpose of [N, K] weights bt (output n's codes at bt[n K ...]):
// one (128-row tile, K split); dst[split][m][n].
template <int MR, typename Act, typename BT, typename Dec>
__global__ void __launch_bounds__(kGemvThreads) posit_gemv_f_t_kernel(
    Act act, const BT* __restrict__ bt, Dec dec, float* __restrict__ dst,
    int M, int N, int K, int KS, int vec) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.y;
  const int k0 = split * KS;
  const int nk = min(K - k0, KS);
  const int nsteps = (nk + kTSpan - 1) / kTSpan;

  // the split's activations, f32, zero past K and M: code r of the split
  // (step r / 256, lane (r / 8) % 32, half (r / 4) % 2, element r % 4) at
  // float4 (step * 2 + half) * 32 + lane of row m's plane
  for (int i = threadIdx.x; i < MR * KS; i += kGemvThreads) {
    const int m = i / KS, r = i % KS;
    const int slot =
        ((((r >> 8) * 2 + ((r >> 2) & 1)) * 32 + ((r >> 3) & 31)) << 2) |
        (r & 3);
    xs[m * KS + slot] =
        (m < M && r < nk) ? act((size_t)m * K + k0 + r) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_first = blockIdx.x * kTRows + warp;
  for (int q = 0; q < kTRowsPerWarp; ++q) {
    const int n = n_first + q * kGemvWarps;
    if (n >= N) break;  // warp-uniform
    const BT* row = bt + (size_t)n * K + k0 + lane * kCols;
    float acc[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[m] = 0.0f;
    for (int s0 = 0; s0 < nsteps; s0 += kTInFlight) {
      Row8<BT> w[kTInFlight];
#pragma unroll
      for (int u = 0; u < kTInFlight; ++u) {
        const int s = s0 + u;
        if (s < nsteps)
          w[u].load(row + s * kTSpan, nk - s * kTSpan - lane * kCols,
                    vec != 0);
        else
          w[u].zero();
      }
#pragma unroll
      for (int u = 0; u < kTInFlight; ++u) {
        const int s = s0 + u;
        if (s < nsteps) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float bv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) bv[e] = dec(w[u].code(4 * h + e));
#pragma unroll
            for (int m = 0; m < MR; ++m) {
              const float4 xv = reinterpret_cast<const float4*>(
                  xs + m * KS)[(s * 2 + h) * 32 + lane];
              acc[m] = fmaf(xv.x, bv[0], acc[m]);
              acc[m] = fmaf(xv.y, bv[1], acc[m]);
              acc[m] = fmaf(xv.z, bv[2], acc[m]);
              acc[m] = fmaf(xv.w, bv[3], acc[m]);
            }
          }
        }
      }
    }
    // the 32 lanes' sums by a fixed butterfly (every lane ends with the
    // same bits: each step adds the same two values); lane m writes row m
    float mine = 0.0f;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
      if (lane == m) mine = acc[m];
    }
    if (lane < M) dst[((size_t)split * M + lane) * N + n] = mine;
  }
}

// out[i] = the S partials summed in split order.
__global__ void posit_gemv_f_reduce_kernel(const float* __restrict__ partial,
                                           int S, int MN,
                                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float sum = partial[i];
  for (int s = 1; s < S; ++s) sum += partial[(size_t)s * MN + i];
  out[i] = sum;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > 200 * 1024) return kRefused;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int MR, typename Act, typename BT, typename Dec>
int launch_rows(Act act, const BT* b, Dec dec, float* dst, int M, int N,
                int K, int layout, int KS, int S, cudaStream_t s) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(b) % (kCols * sizeof(BT)) == 0;
  if (layout == 0) {
    const size_t smem = gemv_smem_bytes(MR, KS);
    const int e = set_smem(posit_gemv_f_kernel<MR, Act, BT, Dec>, smem);
    if (e != 0) return e;
    const int vec = N % kCols == 0 && aligned;
    dim3 grid((N + kGemvBN - 1) / kGemvBN, S);
    posit_gemv_f_kernel<MR, Act, BT, Dec><<<grid, kGemvThreads, smem, s>>>(
        act, b, dec, dst, M, N, K, KS, vec);
  } else {
    if (KS % kTSpan != 0) return kRefused;
    const size_t smem = sizeof(float) * (size_t)MR * KS;
    const int e = set_smem(posit_gemv_f_t_kernel<MR, Act, BT, Dec>, smem);
    if (e != 0) return e;
    const int vec = K % kCols == 0 && aligned;
    dim3 grid((N + kTRows - 1) / kTRows, S);
    posit_gemv_f_t_kernel<MR, Act, BT, Dec><<<grid, kGemvThreads, smem, s>>>(
        act, b, dec, dst, M, N, K, KS, vec);
  }
  return (int)cudaGetLastError();
}

template <typename Act, typename BT, typename Dec>
int launch(Act act, const void* b, Dec dec, float* out, float* partial,
           int M, int N, int K, int layout, int KS, int S, cudaStream_t s) {
  if (S < 1 || KS < 1 || (S > 1 && partial == nullptr)) return kRefused;
  // one split writes the output itself
  float* dst = S == 1 ? out : partial;
  const BT* w = static_cast<const BT*>(b);
  int e;
  if (M <= 1)
    e = launch_rows<1>(act, w, dec, dst, M, N, K, layout, KS, S, s);
  else if (M <= 2)
    e = launch_rows<2>(act, w, dec, dst, M, N, K, layout, KS, S, s);
  else if (M <= 4)
    e = launch_rows<4>(act, w, dec, dst, M, N, K, layout, KS, S, s);
  else if (M <= 8)
    e = launch_rows<8>(act, w, dec, dst, M, N, K, layout, KS, S, s);
  else
    return kRefused;
  if (e != 0 || S == 1) return e;
  const int MN = M * N;
  posit_gemv_f_reduce_kernel<<<(MN + 255) / 256, 256, 0, s>>>(partial, S, MN,
                                                              out);
  return (int)cudaGetLastError();
}

template <typename Act>
int launch_weights(Act act, const void* b, int b_bytes, int nb, int esb,
                   int variant, float* out, float* partial, int M, int N,
                   int K, int layout, int KS, int S, cudaStream_t s) {
  if (variant == 1) {
    if (b_bytes != 2 || nb != 16 || esb != 2) return kRefused;
    return launch<Act, int16_t>(act, b, DecodeP16_2{}, out, partial, M, N, K,
                                layout, KS, S, s);
  }
  if (variant != 0) return kRefused;
  const DecodeRuntime dec{nb, esb};
  if (b_bytes == 2)
    return launch<Act, int16_t>(act, b, dec, out, partial, M, N, K, layout,
                                KS, S, s);
  if (b_bytes == 1)
    return launch<Act, int8_t>(act, b, dec, out, partial, M, N, K, layout,
                               KS, S, s);
  return kRefused;
}

}  // namespace

// a: [M, K] activations, contiguous, f32 (a_kind 0) or bf16 (a_kind 1).
// b: weight codes in a container of b_bytes (1 = int8, 2 = int16), layout
// 0 a contiguous [K, N], layout 1 a contiguous [N, K] read as its
// transpose.  variant (the wrapper's `gemv_f_variant`): 0 the run-time
// decode of (nb, esb), 1 the P(16,2) decode (int16 P(16,2) codes).  KS
// codes of K a split, S splits; partial an [S, M, N] f32 scratch when
// S > 1.  out: [M, N] f32.  Returns -1 for a configuration it does not
// take (the wrapper raises ValueError), else a CUDA error code.
extern "C" int posit_gemv_f_launch(const void* a, const void* b, void* out,
                                   void* partial, int M, int N, int K,
                                   int a_kind, int b_bytes, int nb, int esb,
                                   int layout, int variant, int KS, int S,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (layout != 0 && layout != 1) return kRefused;
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  if (a_kind == 0)
    return launch_weights(ActF32{static_cast<const float*>(a)}, b, b_bytes,
                          nb, esb, variant, o, p, M, N, K, layout, KS, S, s);
  if (a_kind == 1)
    return launch_weights(ActBf16{static_cast<const uint16_t*>(a)}, b,
                          b_bytes, nb, esb, variant, o, p, M, N, K, layout,
                          KS, S, s);
  return kRefused;
}
