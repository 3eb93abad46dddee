// Device-side posit codec shared by every kernel of the port.
//
// posit_decode: code -> exact f32, built from bits (the same datapath as
// repro_torch/core/posit.py:decode, which is bit-for-bit the JAX codec).
// posit_encode: f32 -> code, posit-2022 pattern round-to-nearest-even;
// finite non-zero values saturate to minpos/maxpos, inf and nan give NaR.
//
// Formats are passed at run time (posit_decode_fast takes them at compile
// time): n <= 16 and (n - 2) << es <= 120, so
// every decoded value is an exact normal f32.  The encode datapath runs in
// 64-bit integers; the JAX reference proves its body fits in 31 bits, so
// the two agree without any wrap-around.
#pragma once

#include <cstdint>

__device__ __forceinline__ float posit_decode(uint32_t code, int n, int es) {
  const uint32_t mask = (1u << n) - 1u;
  const uint32_t x = code & mask;
  const uint32_t sign = x >> (n - 1);
  const uint32_t xa = sign ? ((0u - x) & mask) : x;
  // left-align the n-1 post-sign bits: the first regime bit sits at bit 30
  const uint32_t body = (xa << (32 - n)) & 0x7FFFFFFFu;
  const uint32_t r0 = (body >> 30) & 1u;
  const uint32_t inv = (r0 ? ~body : body) & 0x7FFFFFFFu;
  const int lz = __clz(inv) - 1;  // run length from bit 30 (inv == 0 -> 31)
  const int m = min(lz, n - 1);
  const int k = r0 ? m - 1 : -m;
  const uint32_t rem = (body << (m + 1)) & 0x7FFFFFFFu;
  const int e = es > 0 ? (int)(rem >> (31 - es)) : 0;
  const int fb = max(n - 3 - es, 0);
  const uint32_t mant = fb > 0 ? (((rem << es) & 0x7FFFFFFFu) >> (31 - fb)) : 0u;
  const int scale = k * (1 << es) + e;
  const uint32_t bits = (sign << 31) | ((uint32_t)(scale + 127) << 23) |
                        (mant << (23 - fb));
  float v = __uint_as_float(bits);
  if (x == 0u) v = 0.0f;
  if (x == (1u << (n - 1))) v = __uint_as_float(0x7FC00000u);  // NaR -> nan
  return v;
}

// posit_decode for a format fixed at compile time, in about 17 integer
// operations instead of some 30 (3 of them IMADs, which issue on the FMA
// pipe): the code sits left-aligned in a 32-bit word, so the sign is bit
// 31, |x| is one IABS and the regime run one __clz of the body xor its own
// sign mask; then
//   k    = r0 ? run - 1 : -run   == (-run) ^ rs  (rs the regime-sign mask)
//   rem  = body << (run + 1)     = [e (ES bits) | fraction | 0...]
//   bits = ((k << ES) + 127) << 23  +  rem >> (9 - ES)  +  sign
// (rem >> (9 - ES) is e << 23 | mantissa, so e adds onto the exponent;
// unsigned arithmetic, no overflow since |k << ES| <= 120).  Zero and NaR
// are the two codes whose body (|x| without its sign bit) is 0.  Bit for
// bit posit_decode(code, N, ES) on every code (the card tests check all
// 2^16 codes of P(16,2)).
template <int N, int ES>
__device__ __forceinline__ float posit_decode_fast(uint32_t code) {
  const uint32_t xu = code << (32 - N);
  const int32_t s = (int32_t)xu >> 31;
  const uint32_t body = ((uint32_t)(((int32_t)xu ^ s) - s)) << 1;
  const int32_t rs = (int32_t)body >> 31;
  const int run = __clz((int32_t)body ^ rs);
  const uint32_t k = (uint32_t)((-run) ^ rs);
  const uint32_t rem = __funnelshift_lc(0u, body, run) << 1;
  const uint32_t bits = k * (1u << (23 + ES)) + (127u << 23) +
                        (rem >> (9 - ES)) + (xu & 0x80000000u);
  return __uint_as_float(body != 0u ? bits : ((uint32_t)s & 0x7FC00000u));
}

__device__ __forceinline__ uint32_t posit_encode(float f, int n, int es) {
  const long long mask = (1LL << n) - 1;
  const int bits = __float_as_int(f);
  const int sign = (bits >> 31) & 1;
  const int exp8 = (bits >> 23) & 0xFF;
  const int mantf = bits & 0x7FFFFF;
  if (exp8 == 255) return 1u << (n - 1);  // inf / nan -> NaR
  if (exp8 == 0 && mantf == 0) return 0u;  // +-0
  // f32 subnormals sit far below minpos: a forced scale saturates them
  const int scale = exp8 == 0 ? -130 : exp8 - 127;
  long long frac = (1LL << 23) | mantf;
  // normalize the fraction register to Fp = n - es bits (F = 23 here)
  const int Fp = n - es;
  const int drop = min(max(23 - Fp, 0), 31);
  const int up = min(max(Fp - 23, 0), 31);
  const bool sticky = (frac & ((1LL << drop) - 1)) != 0;
  frac = (frac >> drop) << up;

  const int k = scale >> es;  // arithmetic shift = floor division
  int e = es > 0 ? (scale & ((1 << es) - 1)) : 0;
  const bool sat_hi = k >= n - 2;
  const bool sat_lo = k <= -(n - 1);
  const int kc = min(max(k, -(n - 2)), n - 3);
  if (sat_hi || sat_lo) e = 0;

  const int rlen = kc >= 0 ? kc + 2 : 1 - kc;
  const long long reg = kc >= 0 ? (((1LL << (kc + 1)) - 1) << 1) : 1LL;
  const long long body_hi = (reg << es) | e;
  const long long body = (body_hi << Fp) | (frac & ((1LL << Fp) - 1));
  const int shift = rlen + es + Fp - (n - 1);  // >= 1 by construction

  const long long g = (body >> (shift - 1)) & 1;
  const bool st = sticky || ((body & ((1LL << (shift - 1)) - 1)) != 0);
  const long long base = body >> shift;
  long long code_abs = base + ((g == 1 && (st || (base & 1))) ? 1 : 0);
  if (sat_hi) code_abs = (1LL << (n - 1)) - 1;  // maxpos
  if (sat_lo) code_abs = 1;                     // minpos
  return (uint32_t)(sign ? ((-code_abs) & mask) : code_abs);
}

// The posit rounding of a magnitude in 32-bit integers, for a format fixed
// at compile time: scale S and a significand L left-aligned in one word
// (its leading one at bit 31) -> the code of |value| (1 .. maxpos), the
// same bits as posit_encode's 64-bit body (K2's variants and K8's
// compile-time accumulator).  The pattern is one arithmetic shift: the
// word [1, 0, exponent, fraction] shifted right by m = k (k >= 0) is the
// regime of k + 1 ones and a zero followed by the rest; [0, 1, exponent,
// fraction] shifted by m = -k - 1 is -k zeros and a one.  The code is the
// pattern's top N - 1 bits rounded to nearest even, the guard the next bit
// and the sticky every bit below (the ones shifted off the word included).
// S clamped to +-((N - 1) 2^ES - 1) gives k = N - 2, whose pattern rounds
// to maxpos, and k = -(N - 1) with a nonzero exponent, which rounds up to
// minpos: every magnitude beyond saturates.  L's bits below bit ES + 2
// must be zero (they would be lost).
template <int N, int ES>
__device__ __forceinline__ uint32_t posit_round_abs(int S, uint32_t L) {
  static_assert(N >= 3 && N <= 16 && ES >= 1 && ES <= 4, "posit format");
  constexpr int SMAX = ((N - 1) << ES) - 1;
  const int Sc = min(max(S, -SMAX), SMAX);
  const int k = Sc >> ES;  // arithmetic shift = floor division
  const int m = k ^ (k >> 31);  // k >= 0: k; k < 0: -k - 1
  const uint32_t w = (k >= 0 ? 0x80000000u : 0x40000000u) |
                     (((uint32_t)Sc << (32 - ES)) >> 2) |
                     ((L << 1) >> (ES + 2));
  const uint32_t pat = (uint32_t)((int32_t)w >> m);
  const uint32_t base = pat >> (33 - N);
  const uint32_t g = (pat >> (32 - N)) & 1u;
  const uint32_t st = (w << (N - m)) != 0u;  // w's bits below the guard
  return base + (g & (st | base));
}

// posit_round_abs with the format at run time (n <= 16, es <= 4; es = 0
// too): the same pattern, the shifts that would reach 32 clamped.
__device__ __forceinline__ uint32_t posit_round_abs_rt(int n, int es, int S,
                                                       uint32_t L) {
  const int smax = ((n - 1) << es) - 1;
  const int Sc = min(max(S, -smax), smax);
  const int k = Sc >> es;  // arithmetic shift = floor division
  const int m = k ^ (k >> 31);
  const uint32_t w = (k >= 0 ? 0x80000000u : 0x40000000u) |
                     (__funnelshift_lc(0u, (uint32_t)Sc, 32 - es) >> 2) |
                     ((L << 1) >> (es + 2));
  const uint32_t pat = (uint32_t)((int32_t)w >> m);
  const uint32_t base = pat >> (33 - n);
  const uint32_t g = (pat >> (32 - n)) & 1u;
  const uint32_t st = (w << (n - m)) != 0u;
  return base + (g & (st | base));
}

// posit_encode for a format fixed at compile time in 32-bit integers
// (K2's variants): bit for bit posit_encode(f, N, ES) on every f32.  f32
// subnormals (exp8 0, scale -127) saturate to minpos as the clamp gives.
template <int N, int ES>
__device__ __forceinline__ uint32_t posit_encode_fast(float f) {
  const uint32_t bits = __float_as_uint(f);
  const uint32_t exp8 = (bits >> 23) & 0xFFu;
  const uint32_t s = (uint32_t)((int32_t)bits >> 31);
  uint32_t code =
      posit_round_abs<N, ES>((int)exp8 - 127, 0x80000000u | (bits << 8));
  code = ((code ^ s) - s) & ((1u << N) - 1u);
  code = (bits << 1) == 0u ? 0u : code;                 // +-0
  return exp8 == 0xFFu ? 1u << (N - 1) : code;          // inf / nan -> NaR
}
