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
// M <= 8, the split-K GEMV (posit_matmul_gemv_kernel over gemv_rows.cuh's
// body, which the float weight path's GEMV shares, then
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
//
// M > 8 (a13 prefill, M = slots x chunk = 256), the exact split-bf16
// tensor-core GEMM (posit_split_rows_kernel, posit_matmul_tc_kernel, then
// posit_matmul_reduce_kernel unless one split writes f32 directly).  At
// M 256 the work is 2 M K N = 361 G operations a layer: 5.38 ms of f32
// FMA at 67 TFLOP/s, so the f32 SIMT form (posit_matmul_tiled_kernel)
// cannot come near torch.matmul; on tensor cores it is four bf16 products
// per multiply-add, 1.46 ms at 989 TFLOP/s, above the 0.42 ms of bytes.
//   * exact products: a posit of <= 16 bits decodes to <= 14 significand
//     bits, so x = hi + lo exactly with hi = bf16(x), lo = bf16(x - hi)
//     (|lo| <= 2^-9 |x|, at most 6 bits), and each of hi.hi, hi.lo, lo.hi,
//     lo.lo is exact in f32: wgmma m64n128k16 bf16 with f32 accumulators
//     runs all four.  The wrapper (`matmul_variant`) sends a call here
//     only where every such product of the two formats is a normal f32
//     (`split_exact`); other pairs keep the f32 SIMT kernel.  A TF32 form
//     (P(13,2) exact in TF32's 11 bits, P(16,2) in two TF32 terms) costs
//     the same: two TF32 MMAs at half the bf16 rate;
//   * the tensor cores' f32 accumulation aligns and truncates inside an
//     MMA rather than rounding like a sequential fmaf, so a K-long chain
//     of MMAs into one accumulator drifts (a bias toward zero of about
//     one ulp per MMA).  Each 64-deep K step therefore starts its 16
//     wgmmas (4 k16 slices x 4 terms) from a zero accumulator (scale-d 0)
//     and is added into the running f32 sum with one plain fadd, as a
//     sequential sum would;
//   * activations decode once, in a pre-pass, into [2, Mp, Kp] bf16 hi /
//     lo rows (zero padded to the tiles), never per column tile; the A
//     operand reaches wgmma from registers (ldmatrix);
//   * a block owns a 128 x 128 output tile (two warpgroups of 64 rows);
//     at M 256 each weight code is decoded twice.  Weight codes of each
//     64-row K step are staged with cp.async (16-byte chunks, zero-filled
//     past K and N) into a ring of two, decoded in shared memory by
//     posit_decode_fast<16, 2> (int16 P(16,2), every a13 projection) or
//     the run-time decode into bf16 hi / lo tiles laid out as wgmma's
//     N-major core matrices; activation tiles arrive by cp.async,
//     double-buffered.  One barrier per K step: step t's wgmmas run
//     while the threads decode step t + 1 and step t + 2's copies fly.
//     What bounds it (PERF.md): the decode, about 20 integer operations
//     a code on the SMs' integer pipes, twice per code at M 256;
//   * a narrow N fills the card by split-K (the wrapper's `tc_split_k`:
//     about one 128-column x 128-row tile per SM, N 1024 at M 256 takes
//     8 splits), partials to an [S, M, N] scratch summed in split order
//     by posit_matmul_reduce_kernel.  No float atomics: two calls on the
//     same inputs are bitwise equal.
// posit_matmul_tiled_kernel (f32 SIMT, one BM x BN output tile per block
// looping over K, each code tile decoded per tile load) serves M > 8 for
// format pairs whose split products could leave f32's normal range.
// Edges are bounds-checked (out-of-range codes count as 0.0), so no
// operand is padded on the host.
//
// Numerics: a P(13,2) x P(16,2) product has at most 9 + 12 significand
// bits, so every product is exact in f32 and FMA equals multiply-then-add;
// only the order of the K-long f32 sum differs from the plain version
// (held to posit_matmul.sum_bound).  At M <= 8 the decode, not the
// arithmetic, bounds the call, so the GEMV stays on the FMA pipe.
#include <cuda_runtime.h>

#include <cstdint>

#include "code_rows.cuh"
#include "gemv_rows.cuh"
#include "posit.cuh"
#include "tc_util.cuh"

namespace {

// ---- M <= 8: split-K GEMV (gemv_rows.cuh) -----------------------------------

template <int MR, typename BT, typename Dec>
__global__ void __launch_bounds__(kGemvThreads) posit_matmul_gemv_kernel(
    ActCodes a, const BT* __restrict__ b, Dec dec,
    float* __restrict__ partial, int M, int N, int K, int KS, int vec) {
  extern __shared__ float4 smem4[];
  gemv_split<MR>(a, b, dec, partial, M, N, K, KS, vec,
                 reinterpret_cast<float*>(smem4));
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
      ActCodes{a, a_bytes, na, esa}, (const BT*)b, dec, partial, M, N, K, KS,
      vec);
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

// ---- M > 8: exact split-bf16 tensor-core GEMM ------------------------------

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 64;
constexpr int kTcThreads = 256;        // 2 warpgroups, 64 x 128 each
constexpr int kTcAPitch = kTcBK + 8;   // bf16 per A row (144 B: ldmatrix
                                       // rows land on distinct banks)

// Activation codes [M, K] -> hi / lo bf16 rows [2][Mp][Kp], zero past M
// and K.
__global__ void posit_split_rows_kernel(const void* __restrict__ a,
                                        int a_bytes, int na, int esa, int M,
                                        int K, int Mp, int Kp,
                                        bf16* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)Mp * Kp;
  if (i >= total) return;
  const int m = (int)(i / Kp), k = (int)(i % Kp);
  const float x = (m < M && k < K)
                      ? ActCodes{a, a_bytes, na, esa}((size_t)m * K + k)
                      : 0.0f;
  split2(x, out[i], out[total + i]);
}

// code j of a 16-byte chunk of weight codes, in the low bits (both
// decoders ignore the bits above n)
template <typename BT>
__device__ __forceinline__ uint32_t chunk_code(const uint32_t* w, int j);
template <>
__device__ __forceinline__ uint32_t chunk_code<int16_t>(const uint32_t* w,
                                                        int j) {
  return w[j >> 1] >> (16 * (j & 1));
}
template <>
__device__ __forceinline__ uint32_t chunk_code<int8_t>(const uint32_t* w,
                                                       int j) {
  return w[j >> 2] >> (8 * (j & 3));
}

// Shared-memory matrix descriptor of a B slice (no swizzle, N-major): core
// matrices of 8 K rows x 8 N columns, 128 contiguous bytes; the leading
// byte offset steps 8 K rows (kTcBN / 8 core matrices, 2048 bytes), the
// stride byte offset 8 N columns (128 bytes).
__device__ __forceinline__ uint64_t wg_desc(const void* smem) {
  return smem_desc(smem, kTcBN / 8 * 128, 128);
}
// D (64 x 128 f32 a warpgroup) += A (registers, 64 x 16) B (smem, 16 x 128,
// N-major); scale_d 0 ignores D's old value
__device__ __forceinline__ void wgmma_128(float* d, const uint32_t* a,
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <typename BT, typename Dec>
__global__ void __launch_bounds__(kTcThreads, 1) posit_matmul_tc_kernel(
    const bf16* __restrict__ a_split, const BT* __restrict__ b, Dec dec,
    float* __restrict__ dst, int M, int N, int K, int Mp, int Kp, int KS,
    int vec) {
  constexpr int kEPC = 16 / sizeof(BT);
  constexpr int kCPR = kTcBN / kEPC;
  constexpr int kChunks = kTcBK * kCPR;
  constexpr int kCPitch = kTcBN + kEPC;          // code-stage row, elements
  constexpr int kBTile = kTcBK * kTcBN;          // bf16 per B term tile
  extern __shared__ uint4 smem_tc[];
  bf16* As = reinterpret_cast<bf16*>(smem_tc);             // [2][2][BM][APitch]
  bf16* Bs = As + 2 * 2 * kTcBM * kTcAPitch;                // [2][2][BK*BN]
  BT* Cs = reinterpret_cast<BT*>(Bs + 2 * 2 * kBTile);      // [2][BK][CPitch]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * kTcBM;
  const int split = blockIdx.z;
  const int kbeg = split * KS;
  const int nk = KS / kTcBK;
  const size_t term = (size_t)Mp * Kp;

  auto issue_a = [&](int t, int st) {
    constexpr int per_row = kTcBK / 8;
    for (int c = tid; c < 2 * kTcBM * per_row; c += kTcThreads) {
      const int tm = c / (kTcBM * per_row);
      const int rem = c % (kTcBM * per_row);
      const int row = rem / per_row, k8 = (rem % per_row) * 8;
      cp_async16_zfill(
          As + ((st * 2 + tm) * kTcBM + row) * kTcAPitch + k8,
          a_split + tm * term + (size_t)(m0 + row) * Kp + kbeg + t * kTcBK +
              k8,
          true);
    }
  };
  auto issue_b = [&](int t, int st) {
    BT* cs = Cs + st * kTcBK * kCPitch;
    for (int c = tid; c < kChunks; c += kTcThreads) {
      const int r = c / kCPR, col = (c % kCPR) * kEPC;
      const int gk = kbeg + t * kTcBK + r, gn = n0 + col;
      if (vec) {
        const bool ok = gk < K && gn < N;
        cp_async16_zfill(cs + r * kCPitch + col,
                         ok ? b + (size_t)gk * N + gn : b, ok);
      } else {
#pragma unroll
        for (int e = 0; e < kEPC; ++e)
          cs[r * kCPitch + col + e] =
              (gk < K && gn + e < N) ? b[(size_t)gk * N + gn + e] : (BT)0;
      }
    }
  };
  // chunk c: K row c % BK, columns (c / BK) kEPC ..; consecutive threads
  // take consecutive rows, so code reads and core-matrix writes are free
  // of bank conflicts
  auto decode_b = [&](int cst, int bst) {
    const BT* cs = Cs + cst * kTcBK * kCPitch;
    bf16* hi = Bs + (bst * 2) * kBTile;
    bf16* lo = hi + kBTile;
    for (int c = tid; c < kChunks; c += kTcThreads) {
      const int r = c % kTcBK, col = (c / kTcBK) * kEPC;
      const uint4 raw = *reinterpret_cast<const uint4*>(cs + r * kCPitch + col);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e8 = 0; e8 < kEPC; e8 += 8) {
        uint32_t hw[4], lw[4];
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2)
          split2x2(dec(chunk_code<BT>(w, e8 + 2 * e2)),
                   dec(chunk_code<BT>(w, e8 + 2 * e2 + 1)), hw[e2], lw[e2]);
        const int nb = (col + e8) / 8;
        const int off = ((r / 8) * (kTcBN / 8) + nb) * 64 + (r % 8) * 8;
        *reinterpret_cast<uint4*>(hi + off) =
            make_uint4(hw[0], hw[1], hw[2], hw[3]);
        *reinterpret_cast<uint4*>(lo + off) =
            make_uint4(lw[0], lw[1], lw[2], lw[3]);
      }
    }
    fence_proxy_async();  // generic-proxy writes, read by wgmma
  };

  float run[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) run[i] = 0.0f;

  issue_b(0, 0);
  issue_a(0, 0);
  if (nk > 1) issue_b(1, 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  decode_b(0, 0);

  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();
    if (t + 2 < nk) issue_b(t + 2, st);
    if (t + 1 < nk) issue_a(t + 1, st ^ 1);
    cp_async_commit();

    // A fragments of the warp's 16 rows for the step's 4 k16 slices
    const bf16* Ah = As + (st * 2) * kTcBM * kTcAPitch;
    const bf16* Al = Ah + kTcBM * kTcAPitch;
    const int arow = wg * 64 + wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    uint32_t ah[kTcBK / 16][4], al[kTcBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      const int acol = ks * 16 + (lane >> 4) * 8;
      ldmatrix_x4(ah[ks], Ah + arow * kTcAPitch + acol);
      ldmatrix_x4(al[ks], Al + arow * kTcAPitch + acol);
    }
    const bf16* Bh = Bs + (st * 2) * kBTile;
    const bf16* Bl = Bh + kBTile;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // K rows ks 16 .. + 16: core-matrix rows 2 ks and 2 ks + 1
      const int koff = 2 * ks * (kTcBN / 8) * 64;
      wgmma_128(d, ah[ks], wg_desc(Bh + koff), ks != 0);
      wgmma_128(d, ah[ks], wg_desc(Bl + koff), 1);
      wgmma_128(d, al[ks], wg_desc(Bh + koff), 1);
      wgmma_128(d, al[ks], wg_desc(Bl + koff), 1);
    }
    wg_commit();
    if (t + 1 < nk) decode_b(st ^ 1, st ^ 1);
    wg_wait0();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      asm volatile("" : "+f"(d[i])::"memory");
      run[i] = run[i] + d[i];
    }
  }

  // element i: n8 block i / 4, row g + 8 ((i / 2) % 2), column 2 tig + i % 2
  float* out = dst + (size_t)split * M * N;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = m0 + wg * 64 + wq * 16 + g + 8 * ((i >> 1) & 1);
    const int col = n0 + (i >> 2) * 8 + 2 * tig + (i & 1);
    if (row < M && col < N) out[(size_t)row * N + col] = run[i];
  }
}

size_t tc_smem_bytes(int code_bytes) {
  return sizeof(bf16) * (size_t)(2 * 2 * kTcBM * kTcAPitch +
                                 2 * 2 * kTcBK * kTcBN) +
         (size_t)2 * kTcBK * (kTcBN + 16 / code_bytes) * code_bytes;
}

template <typename BT, typename Dec>
int launch_tc(const void* a, int a_bytes, int na, int esa, const void* b,
              Dec dec, void* a_split, float* partial, float* out_f32,
              void* out_codes, int M, int N, int K, int KS, int S, int no,
              int eso, int out_bytes, cudaStream_t s) {
  if (KS < kTcBK || KS % kTcBK != 0 || S < 1 || a_split == nullptr)
    return (int)cudaErrorInvalidValue;
  const int Mp = (M + kTcBM - 1) / kTcBM * kTcBM;
  const int Kp = S * KS;
  const size_t total = (size_t)Mp * Kp;
  posit_split_rows_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      a, a_bytes, na, esa, M, K, Mp, Kp, (bf16*)a_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tc_smem_bytes(sizeof(BT));
  e = cudaFuncSetAttribute(posit_matmul_tc_kernel<BT, Dec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int kEPC = 16 / sizeof(BT);
  const int vec = N % kEPC == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  // one split with f32 out: the tiles write the output directly
  const bool direct = S == 1 && out_f32 != nullptr;
  float* dst = direct ? out_f32 : partial;
  if (dst == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kTcBN - 1) / kTcBN, Mp / kTcBM, S);
  posit_matmul_tc_kernel<BT, Dec><<<grid, kTcThreads, smem, s>>>(
      (const bf16*)a_split, (const BT*)b, dec, dst, M, N, K, Mp, Kp, KS, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return (int)e;
  const int MN = M * N;
  posit_matmul_reduce_kernel<<<(MN + 255) / 256, 256, 0, s>>>(
      partial, S, MN, out_f32, out_codes, no, eso, out_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// a_bytes / b_bytes: code container width of A and B (1 = int8, 2 = int16).
// out_f32 non-null returns f32; otherwise codes of (no, eso) are written
// to out_codes in a container of out_bytes.  variant (the wrapper's
// `matmul_variant`): 0 = tiled f32 SIMT (any M), 1 = split-K GEMV with the
// run-time decode (M <= 8), 2 = split-K GEMV with the P(16,2) decode
// (M <= 8, int16 P(16,2) weights), 3 = the split-bf16 tensor-core GEMM
// with the run-time decode, 4 = the same with the P(16,2) decode (int16
// P(16,2) weights).  Variants 1-4 take KS rows per split, S splits and an
// [S, M, N] f32 scratch `partial` (3 and 4: none when S = 1 and the output
// is f32); 3 and 4 also a bf16 scratch `a_split` of 2 x Mp x S KS (Mp: M
// rounded up to 128).
extern "C" int posit_matmul_launch(const void* a, const void* b,
                                   void* out_f32, void* out_codes,
                                   void* partial, void* a_split, int M,
                                   int N, int K,
                                   int a_bytes, int na, int esa, int b_bytes,
                                   int nb, int esb, int out_bytes, int no,
                                   int eso, int variant, int KS, int S,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* of = (float*)out_f32;
  float* pp = (float*)partial;
  if (a_bytes != 1 && a_bytes != 2) return (int)cudaErrorInvalidValue;
  if (variant == 4) {
    if (b_bytes != 2 || nb != 16 || esb != 2) return (int)cudaErrorInvalidValue;
    return launch_tc<int16_t>(a, a_bytes, na, esa, b, DecodeP16_2{}, a_split,
                              pp, of, out_codes, M, N, K, KS, S, no, eso,
                              out_bytes, s);
  }
  if (variant == 3) {
    const DecodeRuntime dec{nb, esb};
    if (b_bytes == 2)
      return launch_tc<int16_t>(a, a_bytes, na, esa, b, dec, a_split, pp, of,
                                out_codes, M, N, K, KS, S, no, eso, out_bytes,
                                s);
    if (b_bytes == 1)
      return launch_tc<int8_t>(a, a_bytes, na, esa, b, dec, a_split, pp, of,
                               out_codes, M, N, K, KS, S, no, eso, out_bytes,
                               s);
    return (int)cudaErrorInvalidValue;
  }
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
