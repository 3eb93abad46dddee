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
// threads, and the only parallelism is M x N_out.  Here a block of 128
// threads owns a 4 x 32 output tile, one output per thread.  For each slab
// of K (a whole number of chunks) the block decodes the 4 x KT codes of A
// and the KT x 32 codes of B once into shared memory as packed (frac,
// scale, sign, zero, NaR) fields (S1, shared by the tile), then every
// thread walks the slab's chunks in registers: S1 of its accumulator,
// S2 products and the exponent max, S3 alignment with guard and sticky
// bits, S4 the integer sum, S5 the leading-one position, S6 the posit
// rounding into fmt_out.  Arithmetic that the reference runs in int32 and
// that may wrap (shifts by up to 31, the sticky mask at 31, negation and
// the sum) runs in uint32 and is cast back, so no signed overflow or
// oversized shift is undefined here.  B may be given transposed (strides),
// which the logits head's tied embedding is.
//
// Bound on an H100: integer operations, not bytes.  A chunk step (N = 4)
// is some 150-200 integer operations per output; the codes are read once
// per tile.  With one output per thread the chain's latency is hidden only
// by other warps, and at decode (M = 4) a projection of N_out = 1024 gives
// 32 blocks: this first kernel is latency-bound on narrow outputs.
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// a: int16 codes with strides (sa_m, sa_k); b: int16 codes with strides
// (sb_k, sb_n) in elements; out: int32 [M, N_out] fmt_out codes.  The chunk
// size N must be 1, 2, 4, 8 or 16 and divide K.
extern "C" int pdpu_matmul_launch(const void* a, const void* b, void* out,
                                  int M, int K, int NO, long long sa_m,
                                  long long sa_k, long long sb_k,
                                  long long sb_n, int n_in, int es_in,
                                  int n_out, int es_out, int N, int w_m,
                                  int G, int sticky, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N < 1 || K % N) return (int)cudaErrorInvalidValue;
  const Fmt fi{n_in, es_in, max(n_in - 3 - es_in, 0)};
  const Fmt fo{n_out, es_out, max(n_out - 3 - es_out, 0)};
  const int16_t* A = (const int16_t*)a;
  const int16_t* B = (const int16_t*)b;
  int32_t* O = (int32_t*)out;
  switch (N) {
    case 1: return launch<1>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 2: return launch<2>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 4: return launch<4>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 8: return launch<8>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    case 16: return launch<16>(A, B, O, M, K, NO, sa_m, sa_k, sb_k, sb_n, fi, fo, w_m, G, sticky, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
