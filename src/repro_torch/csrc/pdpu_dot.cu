// K8 pdpu_matmul: [M, K] x [K, N_out] posit codes through chunk-size-N
// PDPUs, the paper's S1-S6 integer datapath, int32 fmt_out codes out.
//
// Replaces src/repro/kernels/pdpu_dot.py:pdpu_matmul (_pdpu_gemm_kernel).
// The TPU kernel gives each (bm, bn) output tile one grid step and runs the
// datapath as int32 select chains on the VPU over the whole tile, chunk by
// chunk, re-decoding every operand code for every output (S1 inside
// pdpu_dot).  Bit for bit it is repro_torch/core/pdpu.py:pdpu_matmul_exact.
//
// What the datapath is decides the design.  The accumulator is rounded to
// fmt_out after every chunk of N products, so the K/N chunk steps of one
// output are a sequential chain: K splits neither across blocks nor across
// threads, and the only parallelism is M x N_out.  Each product is shifted
// by its own exponent difference and truncated to the W_m window before
// the integer sum, so a chunk is not a dot product: tensor cores cannot
// run it, and the kernel is SIMT integer work.
//
// Bound on an H100: integer operations at wide outputs (the tied head's
// 1.02 M chains), the chain's latency at narrow ones (a decode projection
// has 4 K to 90 K chains, at most about 5 warps a scheduler).  So the
// design takes off the chain everything that does not depend on the
// accumulator (pdpu_step.cuh): the accumulator is carried as fields (never
// re-decoded from its code), S6 rounds in the log domain, NaR is a
// per-row / per-column flag applied at the end, and the unrolled chunk
// loop lets the next chunk's products and exponent max overlap this
// chunk's S3-S6.  Four producer warps stage each 32-deep K slab: 16-byte
// loads one slab ahead into registers, then the decode into ready-to-use
// fields (significand, exponent field, sign mask) in a double-buffered
// shared slab, while the four consumer warps run the chains of the
// previous slab.  With one producer warp beside each consumer warp on each
// scheduler, no consumer's chain is slowed more than another's.  A block
// owns 4 rows x 32 columns, a warp a row and a lane one chain, at every M:
// more rows a lane (a B field read shared by 4 chains) and 16-row blocks
// (a B code decoded once for 16 rows) were slower at every step shape and
// at prefill M, so the chains spread over the SMs as thinly as the shape
// allows.  B given transposed (the tied head, [N_out, K] storage) is
// loaded along K, 16 bytes a lane.
//
// One kernel template, pdpu_fields_kernel<P>, two kinds of P (the wrapper
// picks the variant, kernels/pdpu_dot.py:pdpu_variant):
// * PdpuFixed: the paper's Table I configurations that the reference
//   names (core/formats.py PDPU_*; the W_m 256 quire excepted, which
//   pdpu._validate refuses as the reference does), formats, N, W_m, guard
//   bits and sticky as template parameters, every shift a constant:
//   p13_16_n4 (the bit_exact policy's), p16_16_n4, p13_16_n8, p10_16_n8
//   (products shifted left, CP = 4) and p13_16_n8_w10 (the accumulator
//   shifted right, CA = -1).
// * PdpuRT<N, wide> ("posit"): every other configuration the wrapper
//   takes (formats of at most 16 bits with one es, N in 1, 2, 4, 8, 16, any
//   W_m, guard bits and sticky that pdpu._validate accepts), the same
//   chain with its fields and shifts as kernel parameters; S6 in a 64-bit
//   word where the magnitude's bits and the scale range do not fit 32.
#include <cuda_runtime.h>

#include <cstdint>

#include "pdpu_step.cuh"

namespace {

constexpr int FX_KT = 32;            // K a slab
constexpr int FX_P = FX_KT + 4;      // field row pitch: 16-byte rows, and
                                     // conflict-free 16-byte lane reads
constexpr int FX_BM = 4;             // rows a block: 4 consumer warps
constexpr int FX_PT = 128;           // producer threads: 4 warps
constexpr int FX_NT = 32 * FX_BM + FX_PT;
constexpr int FX_BUNITS = FX_KT * 32 / 8;  // 8-code units of B a slab
static_assert(FX_BUNITS % FX_PT == 0 && 4 * FX_BM <= FX_PT, "units");

// One slab of decoded fields: B as [column][k], A as [row][k].
struct FxSlab {
  alignas(16) uint32_t bf[32][FX_P];
  alignas(16) int bd[32][FX_P];
  alignas(16) uint32_t bm[32][FX_P];
  alignas(16) uint32_t af[FX_BM][FX_P];
  alignas(16) int ad[FX_BM][FX_P];
  alignas(16) uint32_t am[FX_BM][FX_P];
};

union Codes8 {
  uint4 raw;
  int16_t c[8];
};

// 8 codes at p, p + step, ...: one 16-byte load when vec and all 8 lie in
// range, else `count` scalar loads (the rest zero, the posit zero)
__device__ __forceinline__ uint4 fx_load(const int16_t* p, long long step,
                                         int count, bool vec) {
  Codes8 u;
  if (vec && count == 8) {
    u.raw = __ldg(reinterpret_cast<const uint4*>(p));
    return u.raw;
  }
  u.raw = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < count) u.c[j] = __ldg(p + j * step);
  return u.raw;
}

// 8 codes -> fields, stored as two 16-byte rows at (f, d, m)[0..7]
template <class P>
__device__ __forceinline__ bool fx_store8(const P& p, uint4 raw, int offset,
                                          uint32_t* f, int* d, uint32_t* m) {
  Codes8 cv;
  cv.raw = raw;
  uint32_t fv[8], mv[8];
  int dv[8];
  bool any = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bool nar;
    pdpu_operand(p, (uint32_t)(int)cv.c[j], offset, fv[j], dv[j], mv[j],
                 nar);
    any = any || nar;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    reinterpret_cast<uint4*>(f)[h] =
        make_uint4(fv[4 * h], fv[4 * h + 1], fv[4 * h + 2], fv[4 * h + 3]);
    reinterpret_cast<int4*>(d)[h] =
        make_int4(dv[4 * h], dv[4 * h + 1], dv[4 * h + 2], dv[4 * h + 3]);
    reinterpret_cast<uint4*>(m)[h] =
        make_uint4(mv[4 * h], mv[4 * h + 1], mv[4 * h + 2], mv[4 * h + 3]);
  }
  return any;
}

// N consecutive 32-bit fields from shared memory: 16-byte reads for
// N >= 4 (a row offset N c is 16-byte aligned), else 8- or 4-byte ones
template <int N, typename T>
__device__ __forceinline__ void fx_row(const T* src, T (&dst)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(src)[q];
      dst[4 * q] = (T)x.x;
      dst[4 * q + 1] = (T)x.y;
      dst[4 * q + 2] = (T)x.z;
      dst[4 * q + 3] = (T)x.w;
    }
  } else if constexpr (N == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    dst[0] = (T)x.x;
    dst[1] = (T)x.y;
  } else {
    dst[0] = src[0];
  }
}

// A block owns FX_BM rows x 32 columns: a consumer warp a row, a lane a
// column (one chain); four producer warps stage the slabs.
template <class P>
__global__ void __launch_bounds__(FX_NT) pdpu_fields_kernel(
    const int16_t* __restrict__ a, const int16_t* __restrict__ b,
    int32_t* __restrict__ out, int M, int K, int NO, long long sa_m,
    long long sa_k, long long sb_k, long long sb_n, int a_vec, int b_vec,
    int b_rows, const P p) {
  constexpr int BM = FX_BM, PT = FX_PT, BU = FX_BUNITS / FX_PT, N = P::N;
  static_assert(FX_KT % N == 0, "a slab holds whole chunks");
  __shared__ FxSlab sl[2];
  __shared__ int nar_row[BM], nar_col[32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * 32;
  const int nslab = (K + FX_KT - 1) / FX_KT;
  if (tid < BM) nar_row[tid] = 0;
  if (tid < 32) nar_col[tid] = 0;
  __syncthreads();

  if (tid >= 32 * BM) {
    // ---- producers: one slab ahead in registers, decode into sl[] ----
    const int pt = tid - 32 * BM;
    uint4 rb[BU], ra;
    auto load = [&](int s) {
      const int k0 = s * FX_KT;
#pragma unroll
      for (int q = 0; q < BU; ++q) {
        const int u = pt + q * PT;
        if (b_rows) {  // [K, N_out] rows: 8 columns of one k, a k a lane
          const int kk = u % 32, nn = 8 * (u / 32);
          const int cnt = k0 + kk < K ? min(max(NO - (n0 + nn), 0), 8) : 0;
          rb[q] = fx_load(b + (k0 + kk) * sb_k + (n0 + nn) * sb_n, sb_n, cnt,
                          b_vec);
        } else {       // transposed: 8 k of one column, 4 lanes a column
          const int nn = u / 4, kk = 8 * (u % 4);
          const int cnt = n0 + nn < NO ? min(max(K - (k0 + kk), 0), 8) : 0;
          rb[q] = fx_load(b + (k0 + kk) * sb_k + (n0 + nn) * sb_n, sb_k, cnt,
                          b_vec);
        }
      }
      if (pt < 4 * BM) {
        const int mm = pt / 4, kk = 8 * (pt % 4);
        const int cnt = m0 + mm < M ? min(max(K - (k0 + kk), 0), 8) : 0;
        ra = fx_load(a + (m0 + mm) * sa_m + (k0 + kk) * sa_k, sa_k, cnt,
                     a_vec);
      }
    };
    auto store = [&](FxSlab& S) {
#pragma unroll
      for (int q = 0; q < BU; ++q) {
        const int u = pt + q * PT;
        if (b_rows) {
          const int kk = u % 32, nn = 8 * (u / 32);
          Codes8 cv;
          cv.raw = rb[q];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bool nar;
            pdpu_operand(p, (uint32_t)(int)cv.c[j], 0, S.bf[nn + j][kk],
                         S.bd[nn + j][kk], S.bm[nn + j][kk], nar);
            if (nar) nar_col[nn + j] = 1;
          }
        } else {
          const int nn = u / 4, kk = 8 * (u % 4);
          if (fx_store8(p, rb[q], 0, &S.bf[nn][kk], &S.bd[nn][kk],
                        &S.bm[nn][kk]))
            nar_col[nn] = 1;
        }
      }
      if (pt < 4 * BM) {
        const int mm = pt / 4, kk = 8 * (pt % 4);
        if (fx_store8(p, ra, p.CPR, &S.af[mm][kk], &S.ad[mm][kk],
                      &S.am[mm][kk]))
          nar_row[mm] = 1;
      }
    };
    load(0);
    store(sl[0]);
    if (nslab > 1) load(1);
    __syncthreads();
    for (int s = 0; s < nslab; ++s) {
      if (s + 1 < nslab) {
        store(sl[(s + 1) & 1]);
        if (s + 2 < nslab) load(s + 2);
      }
      __syncthreads();
    }
    return;
  }

  // ---- consumers: a lane owns column n0 + lane of its warp's row ----
  const int row = tid / 32, lane = tid % 32;
  PdpuAcc acc{0u, P::SENT, 0u};
  __syncthreads();  // the first slab is staged
  for (int s = 0; s < nslab; ++s) {
    const FxSlab& S = sl[s & 1];
    auto chunk = [&](int c) {
      uint32_t fa[N], ma[N], fb[N], mb[N], v[N], m[N];
      int da[N], db[N], d[N], ep, nneg;
      fx_row<N>(&S.bf[lane][N * c], fb);
      fx_row<N>(&S.bd[lane][N * c], db);
      fx_row<N>(&S.bm[lane][N * c], mb);
      fx_row<N>(&S.af[row][N * c], fa);
      fx_row<N>(&S.ad[row][N * c], da);
      fx_row<N>(&S.am[row][N * c], ma);
      pdpu_products(p, fa, da, ma, fb, db, mb, v, d, m, ep, nneg);
      pdpu_step(p, acc, v, d, m, ep, nneg);
    };
    const int nch = min(FX_KT, K - s * FX_KT) / N;
    if (nch == FX_KT / N) {
#pragma unroll
      for (int c = 0; c < FX_KT / N; ++c) chunk(c);
    } else {
      for (int c = 0; c < nch; ++c) chunk(c);
    }
    __syncthreads();
  }
  const int m = m0 + row, n = n0 + lane;
  if (m < M && n < NO)
    out[(long long)m * NO + n] = (nar_row[row] | nar_col[lane])
                                     ? (int32_t)(1u << (p.NO - 1))
                                     : (int32_t)pdpu_code(p, acc);
}

template <class P>
int launch_fields(const P& p, const int16_t* a, const int16_t* b,
                  int32_t* out, int M, int K, int NO, long long sa_m,
                  long long sa_k, long long sb_k, long long sb_n,
                  cudaStream_t s) {
  if (sb_k != 1 && sb_n != 1) return (int)cudaErrorInvalidValue;
  const auto al16 = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
  };
  const int a_vec = sa_k == 1 && sa_m % 8 == 0 && al16(a);
  const int b_rows = sb_n == 1;
  const int b_vec = al16(b) && (b_rows ? sb_k % 8 == 0
                                       : sb_k == 1 && sb_n % 8 == 0);
  dim3 grid((NO + 31) / 32, (M + FX_BM - 1) / FX_BM);
  pdpu_fields_kernel<P><<<grid, FX_NT, 0, s>>>(
      a, b, out, M, K, NO, sa_m, sa_k, sb_k, sb_n, a_vec, b_vec, b_rows, p);
  return (int)cudaGetLastError();
}

// the compile-time variants, by the wrapper's variant code
using PdpuP13N4 = PdpuFixed<13, 16, 2, 4, 14, 2, true>;   // 1 p13_16_n4
using PdpuP16N4 = PdpuFixed<16, 16, 2, 4, 14, 2, true>;   // 2 p16_16_n4
using PdpuP13N8 = PdpuFixed<13, 16, 2, 8, 14, 2, true>;   // 3 p13_16_n8
using PdpuP10N8 = PdpuFixed<10, 16, 2, 8, 14, 2, true>;   // 4 p10_16_n8
using PdpuP13N8W10 = PdpuFixed<13, 16, 2, 8, 10, 2, true>;  // 5 p13_16_n8_w10

struct Cfg {
  int n_in, es_in, n_out, es_out, N, w_m, G, sticky;
};

template <class P>
bool matches(const Cfg& c) {
  return c.n_in == P::NI && c.n_out == P::NO && c.es_in == P::ES &&
         c.es_out == P::ES && c.N == P::N && c.w_m == P::WM && c.G == P::G &&
         c.sticky == (int)P::STICKY;
}

// The run-time variant: the configuration's fields, S6's word width.
template <int N>
int launch_rt(const Cfg& c, const int16_t* a, const int16_t* b, int32_t* out,
              int M, int K, int NO, long long sa_m, long long sa_k,
              long long sb_k, long long sb_n, cudaStream_t s) {
  PdpuRTFields f;
  const int kind = c.es_in != c.es_out
                       ? 0
                       : pdpu_rt_fields(f, c.n_in, c.n_out, c.es_in, N,
                                        c.w_m, c.G, c.sticky);
  if (kind == 1) {
    PdpuRT<N, false> p;
    static_cast<PdpuRTFields&>(p) = f;
    return launch_fields(p, a, b, out, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
  }
  if (kind == 2) {
    PdpuRT<N, true> p;
    static_cast<PdpuRTFields&>(p) = f;
    return launch_fields(p, a, b, out, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a: int16 codes with strides (sa_m, sa_k); b: int16 codes with strides
// (sb_k, sb_n) in elements, one of them 1; out: int32 [M, N_out] fmt_out
// codes.  The chunk size N must be 1, 2, 4, 8 or 16 and divide K.  variant
// 0 runs the run-time kernel; 1-5 the compile-time ones (p13_16_n4,
// p16_16_n4, p13_16_n8, p10_16_n8, p13_16_n8_w10), which the configuration
// must match.  Returns 0 or a CUDA error code.
extern "C" int pdpu_matmul_launch(const void* a, const void* b, void* out,
                                  int M, int K, int NO, long long sa_m,
                                  long long sa_k, long long sb_k,
                                  long long sb_n, int n_in, int es_in,
                                  int n_out, int es_out, int N, int w_m,
                                  int G, int sticky, int variant,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N < 1 || K % N) return (int)cudaErrorInvalidValue;
  const int16_t* A = (const int16_t*)a;
  const int16_t* B = (const int16_t*)b;
  int32_t* O = (int32_t*)out;
  const Cfg c{n_in, es_in, n_out, es_out, N, w_m, G, sticky};
#define K8_FIXED(CODE, TYPE)                                            \
  if (variant == CODE)                                                  \
    return matches<TYPE>(c) ? launch_fields(TYPE{}, A, B, O, M, K, NO,  \
                                            sa_m, sa_k, sb_k, sb_n, s)  \
                            : (int)cudaErrorInvalidValue;
  K8_FIXED(1, PdpuP13N4)
  K8_FIXED(2, PdpuP16N4)
  K8_FIXED(3, PdpuP13N8)
  K8_FIXED(4, PdpuP10N8)
  K8_FIXED(5, PdpuP13N8W10)
#undef K8_FIXED
  if (variant != 0) return (int)cudaErrorInvalidValue;
  switch (N) {
    case 1: return launch_rt<1>(c, A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
    case 2: return launch_rt<2>(c, A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
    case 4: return launch_rt<4>(c, A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
    case 8: return launch_rt<8>(c, A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
    case 16: return launch_rt<16>(c, A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
