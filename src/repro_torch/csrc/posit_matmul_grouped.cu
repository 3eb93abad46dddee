// K9 posit_matmul_grouped: per-expert [E, M, K] x [E, K, N] -> [E, M, N],
// the weights posit codes decoded in the kernel; the activations f32
// values or posit codes; f32 out, or one encode into an output format.
//
// Replaces src/repro/kernels/posit_matmul.py:99 posit_matmul_grouped (its
// pl.pallas_call at :143, _grouped_matmul_kernel).  The TPU kernel walks an
// (E, M/bm, N/bn, K/bk) grid, K in order, decoding each code tile on the
// VPU and accumulating on the MXU in an f32 VMEM scratch per expert, one
// encode at the last K step.
//
// Two kernels, chosen by the wrapper's `grouped_variant` from M and the
// formats: the split-K GEMV at M <= 8 (serving: "p16_2", "posit") and for
// float activations or a format pair whose bf16 split is not exact; the
// split-bf16 tensor-core GEMM at M > 8 with coded activations ("tc",
// "tc_p13_2": MoE QAT training).  Both share the occupied-rows pre-pass
// and the split-order reduce.
//
// M <= 8.  At serving shapes M is the expert capacity (8 rows) and a
// decode step routes 4 slots x top-8 to at most 32 of 128 experts: every
// other expert's rows are zeros.  Each weight code is 2 bytes used by at
// most 8 rows, so the routed experts' code bytes bound the call, and the
// decode (about 17 integer operations a code with the compile-time P(16,2)
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
// M > 8 (MoE QAT training: qwen3-moe-235b's 40 capacity rows of a
// 512-token microbatch over E 128, deepseek-moe-16b's 64 over E 64; P(13,2)
// activations and weights), the exact split-bf16 tensor-core GEMM
// (grouped_split_rows_kernel, grouped_tc_kernel, then grouped_reduce_kernel
// unless one split writes f32 directly).  A layer's
// three expert GEMMs are 2 E M K N = 193 GFLOP at qwen3 (2.88 ms of f32
// FMA), 4.83 GB of weight codes (1.44 ms at 3.35 TB/s): the GEMV, which
// reads and decodes every code once per 8-row tile (5 times at M 40, 8
// at M 64), cannot come near torch.bmm.  Here every code is read and
// decoded once per 64-row tile (once at M <= 64):
//   * roles: the weights are wgmma's A operand and the activations its B,
//     so D = W^T X^T, [N, M] a block.  A warpgroup owns 64 weight columns
//     (wgmma's M), the block's 64 token rows are wgmma's N (n64).  A block
//     owns (expert, 64-row M tile, 128 weight columns = 2 warpgroups, one
//     K split).  The weights reach wgmma from registers: no decoded tile
//     is written to shared memory or read back by the tensor cores;
//   * exact products (K6's, posit_matmul.cu): a decoded posit of <= 14
//     significand bits is hi + lo exactly, hi = bf16(x), lo = bf16(x -
//     hi), and hi.hi, hi.lo, lo.hi, lo.lo are exact in f32 where the wrapper
//     sends a format pair (`split_exact`): four wgmma m64n64k16 a k16
//     slice.  Each 64-deep K step starts its 16 wgmmas from a zero
//     accumulator (scale-d 0) and is added into the running f32 sum with
//     one fadd, as a sequential sum would (a K-long wgmma chain drifts: the
//     tensor cores align and truncate inside an accumulation);
//   * activations decode and split once a call, in grouped_split_rows_
//     kernel, into bf16 hi / lo tiles already in wgmma's K-major
//     core-matrix order, one 16 KB tile a (expert, 64-row tile, 64-deep K
//     step), zero past M and K: a block copies each step's tile whole.
//     The same pass finds rows[e] (the GEMV has a pre-pass of its own for
//     that);
//   * weight codes of each 64-deep K step (16 KB) and the step's activation
//     tile arrive by cp.async (16-byte chunks, zero-filled past K and N)
//     in a ring of 4 stages, issued 3 steps ahead (a thread's chunk
//     addresses are set up once).  Each thread takes its codes out of the
//     staged rows with ldmatrix.trans (rows of 8 K codes -> a code pair of
//     one weight column: wgmma's A fragment layout), decodes them and
//     splits them into the fragment's hi / lo registers.  One barrier a
//     step; then step t's wgmmas are issued first, and while they run the
//     threads decode step t + 1 into the other register set and only then
//     issue step t + 3's copies (every warp waits at the barrier, so the
//     decode's latency, not the copies', sits on the step's critical path);
//   * the decode ("tc_p13_2", int16 P(13,2) weights: every training
//     expert stack) is one shared-memory load a code: a table of the 8192
//     P(13,2) codes' (hi, lo) bf16 pairs (32 KB, built on the host by the
//     wrapper from the plain decode and copied into each block's shared
//     memory).  Other split-exact formats ("tc") take the run-time decode
//     and split in registers (about 35 integer operations a code);
//   * what bounds it: shared memory.  Per 64-deep step an SM moves about
//     2300 wavefronts of 128 bytes for 8192 codes: the table lookups (a
//     warp's 32 lookups hit random banks: about 1400), the tensor cores'
//     reads of the activation tile (4 products x 2 KB a k16 slice and
//     warpgroup: 512), the copies' fills (256) and ldmatrix (128).  The
//     exact form's operations (4 bf16 products, 40 rows padded to 64: 1.25
//     ms for qwen3's layer) and the code bytes (1.44 ms) stay below it.
//     The decode in registers costs more: posit_decode_fast<13, 2> and the
//     split, about 20 integer operations a code, or half the codes that
//     way and half by the table, measured slower on an H100 (PERF.md);
//   * shared memory: the table 32 KB, 4 stages x (16 KB activation tile +
//     64 x 136 codes, 17 KB) = 164 KB of the 227 KB a block may hold; one
//     block (256 threads) an SM.  The launcher refuses (-1, the wrapper
//     raises ValueError) where the card allows a block less, or the weights
//     are not int16 codes, or the activations not codes;
//   * the split count (`grouped_tc_split_k`, from (M, N, K) alone) brings
//     an expert's tiles x splits near 8 blocks where K allows (the
//     training shapes have 11-32 tiles an expert: one split);
//     one split with an f32 output writes it directly, rows at or past
//     rows[e] as +0.0 (a block whose 64-row tile starts there writes only
//     zeros, reading no codes), else [S, E, M, N] partials summed in split
//     order by grouped_reduce_kernel.  No float atomics: two calls are
//     bitwise equal and an expert's output does not depend on E.
//
// Numerics: decoded codes are exact in f32 and so are the products of a
// P(16,2) weight with a P(13,2) code; a float activation's product rounds
// once in the FMA, as in any f32 GEMM.  Only the order of the K-long sum
// differs from the plain version (torch.matmul), so both kernels are held
// to posit_matmul.sum_bound.  The GEMV stays off the tensor cores: TF32
// would round the P(16,2) weights, and at 8 rows the decode, not the FMAs,
// bounds it.
#include <cuda_runtime.h>

#include <cstdint>

#include "code_rows.cuh"
#include "posit.cuh"
#include "tc_util.cuh"

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

// ---- M > 8, coded activations: the exact split-bf16 tensor-core GEMM ------

constexpr int kTcBM = 64;        // token rows a block: wgmma's N
constexpr int kTcBN = 128;       // weight columns a block: 2 x wgmma's M
constexpr int kTcBK = 64;        // K rows a step
constexpr int kTcThreads = 256;  // 2 warpgroups
constexpr int kTcStages = 4;     // copy ring, issued kTcStages - 1 ahead
constexpr int kCodePitch = kTcBN + 8;  // int16 a staged code row (272 B:
                                       // ldmatrix rows on distinct banks)
constexpr int kActTile = 2 * kTcBM * kTcBK;    // bf16 a stage: hi, lo
constexpr int kCodeTile = kTcBK * kCodePitch;  // int16 a stage
constexpr int kTableSize = 1 << 13;            // P(13,2) codes
constexpr int kRefused = -1;  // a configuration the launcher does not take

constexpr size_t tc_smem_bytes(bool table) {
  return (table ? sizeof(uint32_t) * kTableSize : 0) +
         kTcStages * (sizeof(bf16) * kActTile + sizeof(int16_t) * kCodeTile);
}
static_assert(tc_smem_bytes(true) <= 227 * 1024, "K9 tc: shared memory");

// Activation codes [E, M, K] -> bf16 hi / lo tiles [E][Mp / 64][Kp / 64]
// [2][64 x 64], zero past M and K, and rows[e] as grouped_rows_kernel
// gives it (rows zeroed before; an integer atomicMax a warp, so the
// result does not depend on the order).  A tile holds wgmma's K-major core
// matrices of 8 rows x 8 K values (16 bytes a row), core matrix (kc, mg)
// of K columns 8 kc.. and rows 8 mg.. at element (kc * 8 + mg) * 64.  A
// thread converts one core-matrix row (one 16- or 8-byte load where the
// row's codes are aligned: vec); consecutive threads write consecutive
// 16-byte rows, and a warp's 32 rows lie in one tile, so of one expert.
template <typename AT>
__global__ void __launch_bounds__(256) grouped_split_rows_kernel(
    const AT* __restrict__ a, int na, int esa, int M, int K, int mtiles,
    int ksteps, size_t chunks, int vec, bf16* __restrict__ out,
    int* __restrict__ rows) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < chunks;  // chunks is a multiple of 512: no warp
                                 // is split, but keep every lane in the vote
  constexpr int kPerTile = kTcBM * kTcBK / 8;
  const size_t tile = i / kPerTile;
  const int w = (int)(i % kPerTile);
  const int kc = w / kTcBM, mg = (w / 8) % (kTcBM / 8), r = w % 8;
  const int ks = (int)(tile % ksteps);
  const size_t em = tile / ksteps;
  const int m = (int)(em % mtiles) * kTcBM + mg * 8 + r;
  const int e = (int)(em / mtiles);
  const int k0 = ks * kTcBK + kc * 8;
  // the 8 codes' container bits, packed as Row8 packs them (code_rows.cuh)
  uint32_t c[4] = {0u, 0u, 0u, 0u};
  if (live && m < M) {
    const AT* src = a + ((size_t)e * M + m) * K + k0;
    if (vec && k0 + 8 <= K) {
      if constexpr (sizeof(AT) == 2) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        c[0] = v.x; c[1] = v.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k0 + j < K) {
          const uint32_t bits = raw_bits(src[j]);
          if constexpr (sizeof(AT) == 2) c[j >> 1] |= bits << (16 * (j & 1));
          else c[j >> 2] |= bits << (8 * (j & 3));
        }
    }
  }
  const bool nz = (c[0] | c[1] | c[2] | c[3]) != 0u;
  float x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    x[j] = posit_decode(elem<AT>(c, j), na, esa);  // code 0 -> +0.0
  const unsigned top = __reduce_max_sync(0xffffffffu, nz ? m + 1 : 0);
  if ((threadIdx.x & 31) == 0 && top > 0) atomicMax(rows + e, (int)top);
  if (!live) return;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) split2x2(x[2 * j], x[2 * j + 1], hi[j], lo[j]);
  bf16* dst = out + tile * kActTile + (size_t)w * 8;
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + kActTile / 2) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// D (64 x 64 f32 a warpgroup) += A (registers, 64 x 16) B (smem, 16 x 64,
// K-major); scale_d 0 ignores D's old value
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keep a register's value where it is until this point (a wgmma may still
// read or write it)
__device__ __forceinline__ void hold(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void hold(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// a warpgroup's A fragments of one 64-deep K step: [k16 slice][hi, lo][4]
using Frags = uint32_t[kTcBK / 16][2][4];

// One (expert, 64-row M tile, 128 weight columns, K split): the split's
// sums D^T = (X W)[m0.., n0..] of rows below rows[e], to dst[split][e]
// (+0.0 from rows[e] on).  kTab: weights decode through the P(13,2) table
// `table` (copied into shared memory); else through `dec`.
template <bool kTab>
__global__ void __launch_bounds__(kTcThreads, 1) grouped_tc_kernel(
    const bf16* __restrict__ a_split, const int16_t* __restrict__ b,
    const uint32_t* __restrict__ table, DecodeRuntime dec,
    const int* __restrict__ rows, float* __restrict__ dst, int E, int M,
    int N, int K, int mtiles, int ksteps, int KS, int vec, int direct) {
  const int tid = threadIdx.x;
  const int e = blockIdx.z / mtiles;
  const int m0 = (blockIdx.z % mtiles) * kTcBM;
  const int n0 = blockIdx.x * kTcBN;
  const int split = blockIdx.y;
  const int used = rows[e];
  float* out = dst + ((size_t)split * E + e) * M * N;
  if (m0 >= used) {  // no token in this tile: no code is read
    if (direct)
      for (int i = tid; i < kTcBM * kTcBN; i += kTcThreads) {
        const int m = m0 + i / kTcBN, n = n0 + i % kTcBN;
        if (m < M && n < N) out[(size_t)m * N + n] = 0.0f;
      }
    return;
  }

  extern __shared__ uint4 smem_k9[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem_k9);
  bf16* acts = reinterpret_cast<bf16*>(tab + (kTab ? kTableSize : 0));
  int16_t* codes = reinterpret_cast<int16_t*>(acts + kTcStages * kActTile);

  const int nk = KS / kTcBK;
  const int kbeg = split * KS;
  const bf16* a_tiles =
      a_split + ((size_t)blockIdx.z * ksteps + (size_t)split * nk) * kActTile;
  const int16_t* be = b + (size_t)e * K * N;

  // step t's activation tile and weight codes into stage t % kTcStages: a
  // thread copies 4 16-byte chunks of the tile and 4 chunks of codes of
  // one 8-column group (K rows crow + 16 i), addresses set up once
  static_assert(kActTile / 8 == 4 * kTcThreads &&
                    kTcBK * (kTcBN / 8) == 4 * kTcThreads,
                "K9 tc: 4 chunks of each a thread");
  const int crow = tid / (kTcBN / 8), ccol = (tid % (kTcBN / 8)) * 8;
  const int16_t* csrc = be + (size_t)(kbeg + crow) * N + n0 + ccol;
  auto issue = [&](int t) {
    const int st = t % kTcStages;
    bf16* as = acts + st * kActTile + tid * 8;
    const bf16* ag = a_tiles + (size_t)t * kActTile + tid * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async16_zfill(as + i * kTcThreads * 8, ag + i * kTcThreads * 8, true);
    int16_t* cs = codes + st * kCodeTile + crow * kCodePitch + ccol;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = kbeg + t * kTcBK + crow + 16 * i;
      const int16_t* src = csrc + (size_t)(t * kTcBK + 16 * i) * N;
      if (vec) {
        const bool ok = gk < K && n0 + ccol < N;
        cp_async16_zfill(cs + 16 * i * kCodePitch, ok ? src : be, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cs[16 * i * kCodePitch + j] =
              (gk < K && n0 + ccol + j < N) ? src[j] : (int16_t)0;
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  // ldmatrix.trans: lanes 8 j .. 8 j + 7 give the K rows of 8 x 8 code
  // matrix j: (columns 0-7, K 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  // of the warp's 16 weight columns -> A fragment registers a0a1 .. a6a7
  const int lk = (lane & 7) + (lane >> 4) * 8;
  const int lc = wg * 64 + wq * 16 + ((lane >> 3) & 1) * 8;

  // step t's weight codes -> the warp's hi / lo A fragments
  auto decode = [&](int t, Frags& A) {
    const int16_t* cs = codes + (t % kTcStages) * kCodeTile;
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      uint32_t raw[4];  // two codes each: K rows 2 tig, 2 tig + 1
      ldmatrix_x4_trans(raw, cs + (ks * 16 + lk) * kCodePitch + lc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kTab) {
          const uint32_t e0 = tab[raw[j] & 0x1FFFu];
          const uint32_t e1 = tab[(raw[j] >> 16) & 0x1FFFu];
          A[ks][0][j] = __byte_perm(e0, e1, 0x5410);  // the two hi halves
          A[ks][1][j] = __byte_perm(e0, e1, 0x7632);  // the two lo halves
        } else {
          split2x2(dec(raw[j] & 0xFFFFu), dec(raw[j] >> 16), A[ks][0][j],
                   A[ks][1][j]);
        }
      }
    }
  };

  // B descriptors of the activation tiles (K-major, no swizzle): core
  // matrices of 8 rows x 8 K, LBO 8 core matrices of 128 bytes (the next
  // 8 K), SBO 128 bytes (the next 8 rows)
  const uint64_t dbase = smem_desc(acts, kTcBM / 8 * 128, 128);
  float run[32], d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = d[i] = 0.0f;
  Frags A0, A1;

  if constexpr (kTab)
    for (int c = tid; c < kTableSize / 4; c += kTcThreads)
      cp_async16_zfill(tab + c * 4, table + c * 4, true);
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();  // the table rides in stage 0's group
  }
  cp_async_wait<kTcStages - 2>();
  fence_proxy_async();
  __syncthreads();
  decode(0, A0);

  // step t: its wgmmas on `cur`, then step t + 1's decode into `nxt` and
  // the copies for step t + 3
  auto step = [&](int t, Frags& cur, Frags& nxt) {
    cp_async_wait<kTcStages - 3>();  // step t + 1's stage has landed
    fence_proxy_async();
    __syncthreads();  // every warp is past step t - 1: its stage is free
    // the stage's activation tile: descriptors advance by address / 16
    const uint64_t dt = dbase + (t % kTcStages) * (kActTile * 2 / 16);
#pragma unroll
    for (int i = 0; i < 32; ++i) hold(d[i]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // K rows 16 ks .. + 16: core matrices kc = 2 ks, 2 ks + 1 (2048
      // bytes in), hi then lo (kActTile bytes further)
      const uint64_t dh = dt + ks * (2 * (kTcBM / 8) * 128 / 16);
      const uint64_t dl = dh + kActTile / 16;
      wgmma_n64(d, cur[ks][0], dh, ks != 0);
      wgmma_n64(d, cur[ks][0], dl, 1);
      wgmma_n64(d, cur[ks][1], dh, 1);
      wgmma_n64(d, cur[ks][1], dl, 1);
    }
    wg_commit();
    // while the tensor cores run: step t + 1's decode, then the copies for
    // step t + 3 into step t - 1's stage
    if (t + 1 < nk) decode(t + 1, nxt);
    if (t + kTcStages - 1 < nk) issue(t + kTcStages - 1);
    cp_async_commit();
    wg_wait0();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hold(cur[ks][0][j]);
        hold(cur[ks][1][j]);
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      hold(d[i]);
      run[i] = run[i] + d[i];
    }
  };
  for (int t = 0; t < nk; t += 2) {
    step(t, A0, A1);
    if (t + 1 < nk) step(t + 1, A1, A0);
  }

  // element i: token rows (n8 block i / 4) 2 tig + i % 2, weight column
  // g + 8 ((i / 2) % 2) of the warp's 16
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = n0 + wg * 64 + wq * 16 + g + 8 * ((i >> 1) & 1);
    const int m = m0 + (i >> 2) * 8 + 2 * tig + (i & 1);
    if (m < M && n < N) out[(size_t)m * N + n] = m < used ? run[i] : 0.0f;
  }
}

template <typename AT, bool kTab>
int launch_tc(const void* a, int na, int esa, const void* b,
              const uint32_t* table, DecodeRuntime dec, int* rows,
              bf16* a_split, float* partial, float* out_f32, void* out_codes,
              int E, int M, int N, int K, int KS, int S, int no, int eso,
              int out_bytes, cudaStream_t s) {
  const int mtiles = (M + kTcBM - 1) / kTcBM;
  if (KS < kTcBK || KS % kTcBK != 0 || S < 1 || S > 65535 ||
      (long long)E * mtiles > 65535 || a_split == nullptr ||
      (kTab && table == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = tc_smem_bytes(kTab);
  if (smem > (size_t)optin) return kRefused;
  // one split with f32 out: the tiles write the output directly
  const bool direct = S == 1 && out_f32 != nullptr;
  float* dst = direct ? out_f32 : partial;
  if (dst == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(grouped_tc_kernel<kTab>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(rows, 0, sizeof(int) * E, s);
  if (err != cudaSuccess) return (int)err;
  const int ksteps = S * KS / kTcBK;
  const size_t chunks = (size_t)E * mtiles * ksteps * (kTcBM * kTcBK / 8);
  const int avec = K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  grouped_split_rows_kernel<AT><<<(unsigned)((chunks + 255) / 256), 256, 0,
                                  s>>>((const AT*)a, na, esa, M, K, mtiles,
                                       ksteps, chunks, avec, a_split, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need every row's 8-code groups aligned
  const int vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid((N + kTcBN - 1) / kTcBN, S, E * mtiles);
  grouped_tc_kernel<kTab><<<grid, kTcThreads, smem, s>>>(
      a_split, (const int16_t*)b, table, dec, rows, dst, E, M, N, K, mtiles,
      ksteps, KS, vec, direct);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const size_t EMN = (size_t)E * M * N;
  grouped_reduce_kernel<<<(unsigned)((EMN + 255) / 256), 256, 0, s>>>(
      partial, rows, S, M, N, EMN, out_f32, out_codes, no, eso, out_bytes);
  return (int)cudaGetLastError();
}

template <bool kTab>
int launch_tc_a(int a_kind, const void* a, int na, int esa, const void* b,
                const uint32_t* table, DecodeRuntime dec, int* rows,
                bf16* a_split, float* partial, float* of, void* oc, int E,
                int M, int N, int K, int KS, int S, int no, int eso, int ob,
                cudaStream_t s) {
  if (a_kind == 1)
    return launch_tc<int8_t, kTab>(a, na, esa, b, table, dec, rows, a_split, partial, of, oc, E, M, N, K, KS, S, no, eso, ob, s);
  if (a_kind == 2)
    return launch_tc<int16_t, kTab>(a, na, esa, b, table, dec, rows, a_split, partial, of, oc, E, M, N, K, KS, S, no, eso, ob, s);
  return kRefused;  // float activations take the GEMV
}

}  // namespace

// a_kind: 0 = f32 activations, 1 = int8 codes of (na, esa), 2 = int16
// codes.  b_bytes: weight code container (1 or 2).  out_f32 non-null
// returns f32; otherwise codes of (no, eso) go to out_codes in a container
// of out_bytes.  variant (the wrapper's `grouped_variant`): 0 = the GEMV
// with the run-time weight decode, 1 = the GEMV with the P(16,2) decode
// (int16 P(16,2) weights), 2 = the tensor-core GEMM with the run-time
// decode, 3 = the tensor-core GEMM with the P(13,2) table `table` (8192
// (hi, lo) bf16 pairs; int16 P(13,2) weights).  Variants 2 and 3 take
// coded activations and int16 weights (else -1, as for a block's shared
// memory beyond the card's) and a bf16 scratch `a_split` of 2 x E x Mp x
// S KS (Mp: M rounded up to 64).  rows: an int32 scratch of E entries;
// partial: an f32 scratch of [S, E, M, N] (variants 2 and 3: none when
// S = 1 and the output is f32); KS rows per K split, S splits
// (`grouped_split_k`, `grouped_tc_split_k`).
extern "C" int posit_matmul_grouped_launch(
    const void* a, const void* b, void* out_f32, void* out_codes, void* rows,
    void* partial, void* a_split, void* table, int E, int M, int N, int K,
    int a_kind, int na, int esa, int b_bytes, int nb, int esb,
    int out_bytes, int no, int eso, int variant, int KS, int S,
    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* of = (float*)out_f32;
  float* pp = (float*)partial;
  int* rw = (int*)rows;
  const DecodeRuntime dec{nb, esb};
  if (variant == 2 || variant == 3) {
    if (b_bytes != 2) return kRefused;
    if (variant == 3 && (nb != 13 || esb != 2))
      return (int)cudaErrorInvalidValue;
    auto launch = variant == 3 ? launch_tc_a<true> : launch_tc_a<false>;
    return launch(a_kind, a, na, esa, b, (const uint32_t*)table, dec, rw,
                  (bf16*)a_split, pp, of, out_codes, E, M, N, K, KS, S, no,
                  eso, out_bytes, s);
  }
  if (variant == 1) {
    if (b_bytes != 2 || nb != 16 || esb != 2) return (int)cudaErrorInvalidValue;
    return launch_a<int16_t>(a_kind, a, na, esa, b, DecodeP16_2{}, rw, pp, of,
                             out_codes, E, M, N, K, KS, S, no, eso, out_bytes,
                             s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (b_bytes == 2)
    return launch_a<int16_t>(a_kind, a, na, esa, b, dec, rw, pp, of,
                             out_codes, E, M, N, K, KS, S, no, eso, out_bytes,
                             s);
  if (b_bytes == 1)
    return launch_a<int8_t>(a_kind, a, na, esa, b, dec, rw, pp, of, out_codes,
                            E, M, N, K, KS, S, no, eso, out_bytes, s);
  return (int)cudaErrorInvalidValue;
}
