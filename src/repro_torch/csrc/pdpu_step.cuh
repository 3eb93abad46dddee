// One chunk step of the chunked-PDPU datapath for a configuration fixed at
// compile time (K8's compile-time variant, csrc/pdpu_dot.cu), with the
// accumulator carried as decoded fields from one step to the next.
//
// Bit for bit the reference's S1-S6 (repro_torch/core/pdpu.py:pdpu_dot)
// rearranged so that the chain through the accumulator is short:
//   * operands arrive as fields: significand f, an exponent field d and a
//     sign mask (0 or ~0).  A zero operand has f = 0 and d = SENT, far
//     below every real exponent, so a zero product (f = 0) never wins the
//     exponent max, as NEG_INF keeps it out in the reference;
//   * every term is a right shift by r = e_max - d >= 0: a product's d
//     carries its fixed right shift -CP, the accumulator's significand is
//     pre-shifted left by CA, so S3 is two funnel shifts: the kept bits
//     and the dropped ones, whose OR is the sticky bit.  Shifts clamp at
//     32, which is the reference's clamp at 31 for these widths;
//   * two's complement as x ^ mask, the +1s summed once (nneg);
//   * S6 rounds in the log domain, one 32-bit word holding scale and
//     fraction (pdpu_round), and the accumulator's fields for the next step
//     are read off the rounded word: no 64-bit arithmetic, no pattern and
//     no decode of a code on the chain, no NaR test (NaR is a per-row /
//     per-column flag of the operands, applied once at the end); the
//     code is packed once, after the last step.
// The sum never wraps at these widths (static_asserts below), so int32
// arithmetic is the reference's wrap-around int32 arithmetic.
#pragma once

#include <cstdint>

#include "posit.cuh"

template <int NI_, int NO_, int ES_, int N_, int WM_, int G_, bool STICKY_>
struct PdpuFixed {
  static constexpr int NI = NI_, NO = NO_, ES = ES_, N = N_, WM = WM_,
                       G = G_;
  static constexpr bool STICKY = STICKY_;
  static constexpr int FBI = NI - 3 - ES;  // fraction bits of an input
  static constexpr int FBO = NO - 3 - ES;  // of the accumulator
  // a term's left shift when its exponent is e_max: (e - fb) - lsb + G
  static constexpr int CP = WM - 2 - 2 * FBI + G;  // products
  static constexpr int CA = WM - 2 - FBO + G;      // the accumulator
  static constexpr int SENT = -(1 << 20);          // d of a zero operand
  static constexpr int SCALE0 = 2 - WM - G;        // f_scale = e_max + SCALE0 + p
  static constexpr int FW = 20;  // fraction bits of S6's log-domain word
  static_assert(ES >= 1 && FBI >= 1 && FBO >= 1, "formats");
  static_assert(CP <= 0 && CA >= 0,
                "products only shift right, the accumulator is pre-shifted");
  static_assert(2 * FBI + 2 <= 31 && FBO + 1 + CA <= 31, "terms in 31 bits");
  // every term is below 2^(WM + G): the sum of N + 1 never wraps, and the
  // left-aligned magnitude loses no bit in posit_round_abs
  static_assert(((long long)(N + 1) << (WM + G)) < (1LL << 31), "no wrap");
  // the magnitude's fraction fits S6's word, whose scale part holds
  // [-MAXS - 1, MAXS]
  static_assert(((long long)(N + 1) << (WM + G)) <= (1LL << (FW + 1)) &&
                    (((NO - 2) << ES) + 1) < (1 << (30 - FW)),
                "S6's word");
  static_assert(ES + FW - NO + 3 >= 1, "S6 rounds below the word's scale");
};

// An operand code (low NI bits of the int16 container) -> its fields.
// d is scale + offset (A carries the products' CP); nar is set for
// the NaR code, whose fields are a zero's.
template <class P>
__device__ __forceinline__ void pdpu_operand(uint32_t code, int offset,
                                             uint32_t& f, int& d,
                                             uint32_t& m, bool& nar) {
  const uint32_t xu = code << (32 - P::NI);
  const uint32_t s = (uint32_t)((int32_t)xu >> 31);
  const uint32_t body = ((xu ^ s) - s) << 1;  // |x| without its sign bit
  const int32_t rs = (int32_t)body >> 31;
  const int run = __clz((int32_t)body ^ rs);
  const int k = (-run) ^ rs;
  const uint32_t rem = __funnelshift_lc(0u, body, run) << 1;
  const int scale = k * (1 << P::ES) + (int)(rem >> (32 - P::ES));
  const uint32_t frac = (1u << P::FBI) | ((rem << P::ES) >> (32 - P::FBI));
  f = body != 0u ? frac : 0u;
  d = body != 0u ? scale + offset : P::SENT;
  m = body != 0u ? s : 0u;
  nar = body == 0u && s != 0u;
}

// The accumulator between chunk steps: sig = its significand << CA (0 for
// zero), ec its scale (SENT for zero), neg its sign mask.
struct PdpuAcc {
  uint32_t sig;
  int ec;
  uint32_t neg;
};

// S3 for one term: shift right by r (clamped at 32), the dropped bits'
// OR into the LSB when sticky, then xor the sign mask.
template <class P>
__device__ __forceinline__ uint32_t pdpu_term(uint32_t v, uint32_t r,
                                              uint32_t m) {
  uint32_t t = __funnelshift_rc(v, 0u, r);
  if (P::STICKY) {
    const uint32_t dropped = __funnelshift_rc(0u, v, r);
#ifdef __CUDA_ARCH__
    uint32_t st;  // min(dropped, 1) as one VIMNMX, not a compare and select
    asm("min.u32 %0, %1, 1;" : "=r"(st) : "r"(dropped));
    t |= st;
#else
    t |= min(dropped, 1u);
#endif
  }
  return t ^ m;
}

// S6 in the log domain: the posit pattern's rounding of a magnitude of
// scale S and significand L (leading one at bit 31) is the round to
// nearest even of Y = S 2^FW + fraction at bit D = ES + FW - n_avail,
// where n_avail = NO - 1 - rlen is the number of exponent and fraction
// bits the regime leaves (Y's bits above ES + FW are the regime's k, so a
// carry out of the exponent is the regime's carry).  One exception: with
// n_avail = 0 the code's last bit is the regime's terminator, the inverse
// of k's parity, so ties flip.  S clamped to [-MAXS - 1, MAXS] gives
// minpos / maxpos for every magnitude beyond them (D there rounds to a
// multiple of 8 in S, no tie possible).  Returns the rounded scale and
// the significand << CA.
template <class P>
__device__ __forceinline__ void pdpu_round(int S, uint32_t L, int& ec,
                                           uint32_t& sig) {
  constexpr int FW = P::FW, MAXS = (P::NO - 2) << P::ES;
  const int Sc = min(max(S, -MAXS - 1), MAXS);
  const int k = Sc >> P::ES;
  const int m = k ^ (k >> 31);                        // rlen = m + 2
  const int D = P::ES + FW - P::NO + 3 + m;
  const int Y = (int)((uint32_t)Sc << FW) | (int)((L << 1) >> (32 - FW));
  const int lsb = ((Y >> D) ^ (m >= P::NO - 3)) & 1;  // n_avail 0: flip
  const int Yr = ((Y + (1 << (D - 1)) - 1 + lsb) >> D) << D;
  ec = Yr >> FW;
  sig = ((uint32_t)Yr & ((1u << FW) - 1u) | (1u << FW)) >> (FW - P::FBO - P::CA);
}

// One chunk step: acc <- round(acc + sum of N products).  v: the exact
// products, d: their exponent fields (scale_a + scale_b + CP, or below
// SENT for a zero product), m: their sign masks, ep: max of d minus CP
// (the products' exponent max), nneg: the number of negative products.
// Everything but acc is independent of the chain.
template <class P>
__device__ __forceinline__ void pdpu_step(PdpuAcc& acc, const uint32_t* v,
                                          const int* d, const uint32_t* m,
                                          int ep, int nneg) {
  const int e = max(ep, acc.ec);  // S2's comparator tree, the last level
  // S3 + S4: the aligned terms' sum; -x = (x ^ ~0) + 1
  int s = nneg - (int)acc.neg;
#pragma unroll
  for (int i = 0; i < P::N; ++i)
    s += (int)pdpu_term<P>(v[i], (uint32_t)(e - d[i]), m[i]);
  s += (int)pdpu_term<P>(acc.sig, (uint32_t)(e - acc.ec), acc.neg);
  // S5: magnitude, leading one, final scale; S6: one rounding
  const uint32_t mag = (uint32_t)(s < 0 ? -s : s);
  const int z = __clz((int)mag);
  int ec;
  uint32_t sig;
  pdpu_round<P>(e + P::SCALE0 + 31 - z, mag << (z & 31), ec, sig);
  acc.neg = (uint32_t)(s >> 31);
  acc.ec = mag != 0u ? ec : P::SENT;
  acc.sig = mag != 0u ? sig : 0u;
}

// The products of one chunk for one output: fields of A's row and B's
// column -> what pdpu_step takes.
template <class P>
__device__ __forceinline__ void pdpu_products(
    const uint32_t* fa, const int* da, const uint32_t* ma, const uint32_t* fb,
    const int* db, const uint32_t* mb, uint32_t* v, int* d, uint32_t* m,
    int& ep, int& nneg) {
  ep = P::SENT * 2;
  nneg = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    v[i] = fa[i] * fb[i];
    d[i] = da[i] + db[i];
    m[i] = ma[i] ^ mb[i];
    ep = max(ep, d[i]);
    nneg -= (int)m[i];
  }
  ep -= P::CP;
}

// The output code of an accumulator: its fmt_out code in [0, 2^NO) (the
// value is a posit of fmt_out, so posit_round_abs only packs it).
template <class P>
__device__ __forceinline__ uint32_t pdpu_code(const PdpuAcc& acc) {
  const uint32_t c = posit_round_abs<P::NO, P::ES>(
      acc.ec, acc.sig << (31 - P::FBO - P::CA));
  return acc.sig != 0u ? ((c ^ acc.neg) - acc.neg) & ((1u << P::NO) - 1u)
                       : 0u;
}
