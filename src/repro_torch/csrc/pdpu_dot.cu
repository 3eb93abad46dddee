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
// run it, and both variants are SIMT integer work.
//
// Two variants, chosen by the wrapper (kernels/pdpu_dot.py:pdpu_variant):
//
// * p13_16_n4 (pdpu_matmul_fixed_kernel), the bit_exact policy's PDPU:
//   P(13,2) in, P(16,2) out, N 4, W_m 14, 2 guard bits, sticky, fixed at
//   compile time.  Bound on an H100: integer operations at wide outputs
//   (the tied head's 1.02 M chains), the chain's latency at narrow ones (a
//   decode projection has 4 K to 90 K chains, at most about 5 warps a
//   scheduler).  So the design takes off the chain everything that does
//   not depend on the accumulator (pdpu_step.cuh): the accumulator is
//   carried as fields (never re-decoded from its code), S6 rounds in 32-bit
//   integers, NaR is a per-row / per-column flag applied at the end, and
//   the unrolled chunk loop lets the next chunk's products and exponent max
//   overlap this chunk's S3-S6.  Four producer warps stage each 32-deep K
//   slab: 16-byte loads one slab ahead into registers, then the
//   compile-time P(13,2) decode into ready-to-use fields (significand,
//   exponent field, sign mask) in a double-buffered shared slab, while the
//   four consumer warps run the chains of the previous slab.  With one
//   producer warp beside each consumer warp on each scheduler, no
//   consumer's chain is slowed more than another's (with two, the two
//   schedulers that held them set the pace at every slab's barrier).  A block
//   owns 4 rows x 32 columns, a warp a row and a lane one chain, at every
//   M: more rows a lane (a B field read shared by 4 chains) and 16-row
//   blocks (a B code decoded once for 16 rows) were slower at every step
//   shape and at prefill M, so the chains spread over the SMs as thinly
//   as the shape allows.  B given transposed (the tied head, [N_out, K]
//   storage) is loaded along K, 16 bytes a lane.
// * posit (pdpu_matmul_kernel): every other configuration, formats and
//   chunk size at run time.  A block of 128 threads owns a 4 x 32 output
//   tile, one output per thread; for each slab of K the block decodes the
//   codes once into shared memory as packed (frac, scale, sign, zero, NaR)
//   fields, then every thread walks the slab's chunks in registers: S1 of
//   its accumulator, S2 products and the exponent max, S3 alignment with
//   guard and sticky bits, S4 the integer sum, S5 the leading-one
//   position, S6 the posit rounding into fmt_out.  Arithmetic that the
//   reference runs in int32 and that may wrap (shifts by up to 31, the
//   sticky mask at 31, negation and the sum) runs in uint32 and is cast
//   back, so no signed overflow or oversized shift is undefined here.  It
//   is latency-bound on narrow outputs.
#include <cuda_runtime.h>

#include <cstdint>

#include "pdpu_step.cuh"

namespace {

constexpr int NEG_INF = -(1 << 24);
constexpr int TX = 32;       // output columns per block
constexpr int TY = 4;        // output rows per block
constexpr int NT = TX * TY;  // threads per block
constexpr int BS_PAD = TX + 1;

struct Fmt {
  int n, es, fb;
};

// decode_unpacked of repro_torch/core/posit.py, packed into one word:
// frac in bits 0-15, scale in bits 16-23 (two's complement), sign bit 24,
// zero bit 25, NaR bit 26.  Zero and NaR carry sign = scale = frac = 0.
__device__ __forceinline__ uint32_t unpack_code(uint32_t code, Fmt f) {
  const uint32_t mask = (1u << f.n) - 1u;
  const uint32_t x = code & mask;
  if (x == 0u) return 1u << 25;
  if (x == (1u << (f.n - 1))) return 1u << 26;
  const uint32_t sign = (x >> (f.n - 1)) & 1u;
  const uint32_t xa = sign ? ((0u - x) & mask) : x;
  const uint32_t body = (xa << (32 - f.n)) & 0x7FFFFFFFu;
  const uint32_t r0 = (body >> 30) & 1u;
  const uint32_t inv = (r0 ? ~body : body) & 0x7FFFFFFFu;
  const int lz = __clz(inv) - 1;  // 31 - bit_length(inv)
  const int m = min(lz, f.n - 1);
  const int k = r0 ? m - 1 : -m;
  const uint32_t rem = (body << (m + 1)) & 0x7FFFFFFFu;
  const int e = f.es > 0 ? (int)(rem >> (31 - f.es)) : 0;
  const uint32_t mant =
      f.fb > 0 ? (((rem << f.es) & 0x7FFFFFFFu) >> (31 - f.fb)) : 0u;
  const uint32_t frac = (1u << f.fb) | mant;
  const int scale = k * (1 << f.es) + e;
  return frac | (((uint32_t)scale & 0xFFu) << 16) | (sign << 24);
}

__device__ __forceinline__ uint32_t u_frac(uint32_t u) { return u & 0xFFFFu; }
__device__ __forceinline__ int u_scale(uint32_t u) {
  return (int)(int8_t)((u >> 16) & 0xFFu);
}
__device__ __forceinline__ uint32_t u_sign(uint32_t u) { return (u >> 24) & 1u; }
__device__ __forceinline__ bool u_zero(uint32_t u) { return (u >> 25) & 1u; }
__device__ __forceinline__ bool u_nar(uint32_t u) { return (u >> 26) & 1u; }

// S3: shift into the window whose LSB weight is 2**lsb, keeping G guard
// bits; shifted-out bits OR into the LSB when sticky.  int32 wrap-around
// of the reference is kept by working in uint32.
__device__ __forceinline__ uint32_t align(uint32_t frac, int e, int fb,
                                          int lsb, int G, bool sticky) {
  int sh = e == NEG_INF ? -31 : (e - fb) - lsb + G;
  sh = min(max(sh, -31), 31);
  if (sh >= 0) return frac << sh;
  const int rs = -sh;  // 1..31
  uint32_t out = frac >> rs;
  if (sticky && (frac & ((1u << rs) - 1u)) != 0u) out |= 1u;
  return out;
}

// posit.encode_core with a per-element F, sticky = 0 (the reference's int32
// semantics; the packed body fits in 31 bits, so int64 here agrees).
__device__ __forceinline__ uint32_t encode_core(int sign, int scale,
                                                int frac, int F, Fmt f) {
  if (frac == 0) return 0u;
  const int n = f.n, es = f.es;
  const int Fp = n - es;
  const int drop = min(max(F - Fp, 0), 31);
  const int up = min(max(Fp - F, 0), 31);
  const bool st0 = ((uint32_t)frac & ((1u << drop) - 1u)) != 0u;
  const long long fr = (long long)((frac >> drop)) << up;
  const int k = scale >> es;  // arithmetic shift = floor division
  int e = es > 0 ? (scale & ((1 << es) - 1)) : 0;
  const bool sat_hi = k >= n - 2;
  const bool sat_lo = k <= -(n - 1);
  const int kc = min(max(k, -(n - 2)), n - 3);
  if (sat_hi || sat_lo) e = 0;
  const int rlen = kc >= 0 ? kc + 2 : 1 - kc;
  const long long reg = kc >= 0 ? (((1LL << (kc + 1)) - 1) << 1) : 1LL;
  const long long body_hi = (reg << es) | e;
  const long long body = (body_hi << Fp) | (fr & ((1LL << Fp) - 1));
  const int shift = rlen + es + Fp - (n - 1);  // >= 1 by construction
  const long long g = (body >> (shift - 1)) & 1;
  const bool st = st0 || ((body & ((1LL << (shift - 1)) - 1)) != 0);
  const long long base = body >> shift;
  long long code_abs = base + ((g == 1 && (st || (base & 1))) ? 1 : 0);
  if (sat_hi) code_abs = (1LL << (n - 1)) - 1;  // maxpos
  if (sat_lo) code_abs = 1;                     // minpos
  const long long mask = (1LL << n) - 1;
  return (uint32_t)(sign ? ((-code_abs) & mask) : code_abs);
}

template <int N>
__global__ void __launch_bounds__(NT) pdpu_matmul_kernel(
    const int16_t* __restrict__ a, const int16_t* __restrict__ b,
    int32_t* __restrict__ out, int M, int K, int NO, long long sa_m,
    long long sa_k, long long sb_k, long long sb_n, Fmt fi, Fmt fo, int w_m,
    int G, int sticky, int KT) {
  extern __shared__ uint32_t smem[];
  uint32_t* As = smem;            // [TY][KT]
  uint32_t* Bs = smem + TY * KT;  // [KT][BS_PAD]
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * TY, n0 = blockIdx.x * TX;
  const int gm = m0 + ty, gn = n0 + tx;
  const int fbi2 = 2 * fi.fb;
  const uint32_t nar_out = 1u << (fo.n - 1);

  uint32_t acc = 0u;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);  // a whole number of chunks
    for (int i = tid; i < TY * kt; i += NT) {
      const int mm = i / kt, kk = i % kt;
      const int r = m0 + mm;
      As[mm * KT + kk] =
          r < M ? unpack_code((uint32_t)(int)a[r * sa_m + (k0 + kk) * sa_k], fi)
                : (1u << 25);
    }
    if (sb_n == 1) {  // B row-major [K, N_out]: neighbours along N
      for (int i = tid; i < kt * TX; i += NT) {
        const int kk = i / TX, nn = i % TX;
        const int c = n0 + nn;
        Bs[kk * BS_PAD + nn] =
            c < NO ? unpack_code((uint32_t)(int)b[(k0 + kk) * sb_k + c * sb_n], fi)
                   : (1u << 25);
      }
    } else {  // B given transposed ([N_out, K] storage): neighbours along K
      for (int i = tid; i < kt * TX; i += NT) {
        const int kk = i % kt, nn = i / kt;
        const int c = n0 + nn;
        Bs[kk * BS_PAD + nn] =
            c < NO ? unpack_code((uint32_t)(int)b[(k0 + kk) * sb_k + c * sb_n], fi)
                   : (1u << 25);
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < kt; c0 += N) {
      // S1: the accumulator (the operands were decoded into shared memory)
      const uint32_t uc = unpack_code(acc, fo);
      bool nar = u_nar(uc);
      const int e_c = u_zero(uc) ? NEG_INF : u_scale(uc);
      // S2: exact mantissa products, exponent sums, comparator tree
      uint32_t prod[N];
      int e_ab[N];
      uint32_t s_ab[N];
      int e_max = e_c;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const uint32_t ua = As[ty * KT + c0 + i];
        const uint32_t ub = Bs[(c0 + i) * BS_PAD + tx];
        nar = nar || u_nar(ua) || u_nar(ub);
        prod[i] = u_frac(ua) * u_frac(ub);
        s_ab[i] = u_sign(ua) ^ u_sign(ub);
        e_ab[i] = (u_zero(ua) || u_zero(ub)) ? NEG_INF
                                              : u_scale(ua) + u_scale(ub);
        e_max = max(e_max, e_ab[i]);
      }
      const bool all_zero = e_max == NEG_INF;
      const int e_max_s = all_zero ? 0 : e_max;
      const int lsb = e_max_s + 2 - w_m;
      // S3 + S4: align, two's complement, integer sum (wraps as int32)
      uint32_t ssum = 0u;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const uint32_t t = align(prod[i], e_ab[i], fbi2, lsb, G, sticky);
        ssum += s_ab[i] ? 0u - t : t;
      }
      const uint32_t tc = align(u_frac(uc), e_c, fo.fb, lsb, G, sticky);
      ssum += u_sign(uc) ? 0u - tc : tc;
      const int s = (int)ssum;
      const int f_s = s < 0;
      const int sm = s < 0 ? (int)(0u - ssum) : s;  // jnp.abs (wraps at INT_MIN)
      // S5: leading-one position, final scale
      const int p = 31 - __clz(max(sm, 1));
      const int f_scale = (e_max_s + 2 - w_m - G) + p;
      // S6: one rounding into fmt_out
      uint32_t code = encode_core(f_s, f_scale, sm, p, fo);
      if (all_zero || sm == 0) code = 0u;
      if (nar) code = nar_out;
      acc = code;
    }
    __syncthreads();
  }
  if (gm < M && gn < NO) out[(long long)gm * NO + gn] = (int32_t)acc;
}

template <int N>
int launch(const int16_t* a, const int16_t* b, int32_t* out, int M, int K,
           int NO, long long sa_m, long long sa_k, long long sb_k,
           long long sb_n, Fmt fi, Fmt fo, int w_m, int G, int sticky,
           cudaStream_t s) {
  const int KT = N * max(1, 64 / N);
  const size_t smem = (size_t)(TY * KT + KT * BS_PAD) * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((NO + TX - 1) / TX, (M + TY - 1) / TY);
  pdpu_matmul_kernel<N><<<grid, NT, smem, s>>>(a, b, out, M, K, NO, sa_m,
                                               sa_k, sb_k, sb_n, fi, fo, w_m,
                                               G, sticky, KT);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// p13_16_n4: the compile-time variant
// ---------------------------------------------------------------------------

using PF = PdpuFixed<13, 16, 2, 4, 14, 2, true>;
constexpr int FX_KT = 32;            // K a slab: 8 chunks of 4
constexpr int FX_P = FX_KT + 4;      // field row pitch: 16-byte rows, and
                                     // conflict-free 16-byte lane reads
constexpr int FX_BM = 4;             // rows a block: 4 consumer warps
constexpr int FX_PT = 128;           // producer threads: 4 warps
constexpr int FX_NT = 32 * FX_BM + FX_PT;
constexpr int FX_BUNITS = FX_KT * 32 / 8;  // 8-code units of B a slab
static_assert(PF::N == 4, "a chunk is one 16-byte field read");
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
__device__ __forceinline__ bool fx_store8(uint4 raw, int offset,
                                          uint32_t* f, int* d, uint32_t* m) {
  Codes8 cv;
  cv.raw = raw;
  uint32_t fv[8], mv[8];
  int dv[8];
  bool any = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bool nar;
    pdpu_operand<PF>((uint32_t)(int)cv.c[j], offset, fv[j], dv[j], mv[j],
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

// A block owns FX_BM rows x 32 columns: a consumer warp a row, a lane a
// column (one chain); four producer warps stage the slabs.
__global__ void __launch_bounds__(FX_NT) pdpu_matmul_fixed_kernel(
    const int16_t* __restrict__ a, const int16_t* __restrict__ b,
    int32_t* __restrict__ out, int M, int K, int NO, long long sa_m,
    long long sa_k, long long sb_k, long long sb_n, int a_vec, int b_vec,
    int b_rows) {
  constexpr int BM = FX_BM, PT = FX_PT, BU = FX_BUNITS / FX_PT;
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
            pdpu_operand<PF>((uint32_t)(int)cv.c[j], 0, S.bf[nn + j][kk],
                             S.bd[nn + j][kk], S.bm[nn + j][kk], nar);
            if (nar) nar_col[nn + j] = 1;
          }
        } else {
          const int nn = u / 4, kk = 8 * (u % 4);
          if (fx_store8(rb[q], 0, &S.bf[nn][kk], &S.bd[nn][kk],
                        &S.bm[nn][kk]))
            nar_col[nn] = 1;
        }
      }
      if (pt < 4 * BM) {
        const int mm = pt / 4, kk = 8 * (pt % 4);
        if (fx_store8(ra, PF::CP, &S.af[mm][kk], &S.ad[mm][kk],
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
  PdpuAcc acc{0u, PF::SENT, 0u};
  __syncthreads();  // the first slab is staged
  for (int s = 0; s < nslab; ++s) {
    const FxSlab& S = sl[s & 1];
    auto chunk = [&](int c) {
      const uint4 fb4 = *reinterpret_cast<const uint4*>(&S.bf[lane][4 * c]);
      const int4 db4 = *reinterpret_cast<const int4*>(&S.bd[lane][4 * c]);
      const uint4 mb4 = *reinterpret_cast<const uint4*>(&S.bm[lane][4 * c]);
      const uint4 fa4 = *reinterpret_cast<const uint4*>(&S.af[row][4 * c]);
      const int4 da4 = *reinterpret_cast<const int4*>(&S.ad[row][4 * c]);
      const uint4 ma4 = *reinterpret_cast<const uint4*>(&S.am[row][4 * c]);
      const uint32_t fb[4] = {fb4.x, fb4.y, fb4.z, fb4.w};
      const int db[4] = {db4.x, db4.y, db4.z, db4.w};
      const uint32_t mb[4] = {mb4.x, mb4.y, mb4.z, mb4.w};
      const uint32_t fa[4] = {fa4.x, fa4.y, fa4.z, fa4.w};
      const int da[4] = {da4.x, da4.y, da4.z, da4.w};
      const uint32_t ma[4] = {ma4.x, ma4.y, ma4.z, ma4.w};
      uint32_t v[4], m[4];
      int d[4], ep, nneg;
      pdpu_products<PF>(fa, da, ma, fb, db, mb, v, d, m, ep, nneg);
      pdpu_step<PF>(acc, v, d, m, ep, nneg);
    };
    const int nch = min(FX_KT, K - s * FX_KT) / 4;
    if (nch == FX_KT / 4) {
#pragma unroll
      for (int c = 0; c < FX_KT / 4; ++c) chunk(c);
    } else {
      for (int c = 0; c < nch; ++c) chunk(c);
    }
    __syncthreads();
  }
  const int m = m0 + row, n = n0 + lane;
  if (m < M && n < NO)
    out[(long long)m * NO + n] = (nar_row[row] | nar_col[lane])
                                     ? (int32_t)(1u << (PF::NO - 1))
                                     : (int32_t)pdpu_code<PF>(acc);
}

int launch_fixed(const int16_t* a, const int16_t* b, int32_t* out, int M,
                 int K, int NO, long long sa_m, long long sa_k,
                 long long sb_k, long long sb_n, cudaStream_t s) {
  const auto al16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const int a_vec = sa_k == 1 && sa_m % 8 == 0 && al16(a);
  const int b_rows = sb_n == 1;
  const int b_vec = al16(b) && (b_rows ? sb_k % 8 == 0
                                       : sb_k == 1 && sb_n % 8 == 0);
  dim3 grid((NO + 31) / 32, (M + FX_BM - 1) / FX_BM);
  pdpu_matmul_fixed_kernel<<<grid, FX_NT, 0, s>>>(
      a, b, out, M, K, NO, sa_m, sa_k, sb_k, sb_n, a_vec, b_vec, b_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// a: int16 codes with strides (sa_m, sa_k); b: int16 codes with strides
// (sb_k, sb_n) in elements; out: int32 [M, N_out] fmt_out codes.  The chunk
// size N must be 1, 2, 4, 8 or 16 and divide K.  variant 0 runs the
// run-time kernel; variant 1 the compile-time p13_16_n4, which the
// configuration must match (one of sb_k, sb_n must be 1 there).
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
  if (variant == 1) {
    if (n_in != PF::NI || n_out != PF::NO || es_in != PF::ES ||
        es_out != PF::ES || N != PF::N || w_m != PF::WM || G != PF::G ||
        sticky != (int)PF::STICKY || (sb_k != 1 && sb_n != 1))
      return (int)cudaErrorInvalidValue;
    return launch_fixed(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const Fmt fi{n_in, es_in, max(n_in - 3 - es_in, 0)};
  const Fmt fo{n_out, es_out, max(n_out - 3 - es_out, 0)};
  switch (N) {
    case 1: return launch<1>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 2: return launch<2>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 4: return launch<4>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 8: return launch<8>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 16: return launch<16>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
