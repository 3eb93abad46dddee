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
