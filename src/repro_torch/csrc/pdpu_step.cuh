// One chunk step of the chunked-PDPU datapath with the accumulator carried
// as decoded fields from one step to the next (K8, csrc/pdpu_dot.cu), for
// a configuration fixed at compile time (PdpuFixed: every field and shift
// a constant) or given at run time (PdpuRT: the same fields as kernel
// parameters, the chunk size N still a template parameter).
//
// Bit for bit the reference's S1-S6 (repro_torch/core/pdpu.py:pdpu_dot)
// rearranged so that the chain through the accumulator is short:
//   * operands arrive as fields: significand f, an exponent field d and a
//     sign mask (0 or ~0).  A zero operand has f = 0 and d = SENT, far
//     below every real exponent, so a zero product (f = 0) never wins the
//     exponent max, as NEG_INF keeps it out in the reference;
//   * every term is a right shift by r = e_max - d >= 0 of a value that
//     carries its fixed left shift: a product is f_a f_b << CPL and its d
//     carries the fixed right shift CPR (CP = CPL + CPR, one of them 0);
//     the accumulator's significand is pre-shifted left by CAL and its
//     shift adds CAR (CA = CAL - CAR).  S3 is two funnel shifts: the kept
//     bits and the dropped ones, whose OR is the sticky bit.  Shifts clamp
//     at 32, which is the reference's clamp at 31 for terms below 2^31;
//   * two's complement as x ^ mask, the +1s summed once (nneg);
//   * S6 rounds in the log domain, one word holding scale and FW fraction
//     bits (pdpu_round; 32 bits, or 64 for a run-time configuration whose
//     scale and magnitude do not fit one 32-bit word), and the
//     accumulator's fields for the next step are read off the rounded
//     word: no pattern and no decode of a code on the chain, no NaR test
//     (NaR is a per-row / per-column flag of the operands, applied once at
//     the end); the code is packed once, after the last step.
// Every configuration pdpu._validate accepts keeps the sum below 2^30
// (w_m + G + ceil(log2(N + 1)) + 1 <= 31), so int32 arithmetic is the
// reference's wrap-around int32 arithmetic, and no left shift wraps.
#pragma once

#include <cstdint>

#include "posit.cuh"

template <int NI_, int NO_, int ES_, int N_, int WM_, int G_, bool STICKY_>
struct PdpuFixed {
  static constexpr bool kFixed = true, kWide = false;
  static constexpr int NI = NI_, NO = NO_, ES = ES_, N = N_, WM = WM_,
                       G = G_;
  static constexpr bool STICKY = STICKY_;
  static constexpr int FBI = NI - 3 - ES;  // fraction bits of an input
  static constexpr int FBO = NO - 3 - ES;  // of the accumulator
  // a term's left shift when its exponent is e_max: (e - fb) - lsb + G
  static constexpr int CP = WM - 2 - 2 * FBI + G;  // products
  static constexpr int CA = WM - 2 - FBO + G;      // the accumulator
  static constexpr int CPL = CP > 0 ? CP : 0, CPR = CP < 0 ? CP : 0;
  static constexpr int CAL = CA > 0 ? CA : 0, CAR = CA < 0 ? -CA : 0;
  static constexpr int SENT = -(1 << 20);          // d of a zero operand
  static constexpr int SCALE0 = 2 - WM - G;        // f_scale = e_max + SCALE0 + p
  static constexpr int FW = 20;  // fraction bits of S6's log-domain word
  static constexpr int MAXS = (NO - 2) << ES;
  static_assert(ES >= 1 && FBI >= 1 && FBO >= 1, "formats");
  static_assert(2 * FBI + 2 + CPL <= 31 && FBO + 1 + CAL <= 31,
                "terms in 31 bits");
  // every term is below 2^(WM + G): the sum of N + 1 never wraps, and the
  // left-aligned magnitude loses no bit in posit_round_abs
  static_assert(((long long)(N + 1) << (WM + G)) < (1LL << 31), "no wrap");
  // the magnitude's fraction fits S6's word, whose scale part holds
  // [-MAXS - 1, MAXS]
  static_assert(((long long)(N + 1) << (WM + G)) <= (1LL << (FW + 1)) &&
                    MAXS + 1 < (1 << (30 - FW)),
                "S6's word");
  static_assert(ES + FW - NO + 3 >= 1, "S6 rounds below the word's scale");
};

// The same fields for a configuration given at run time
// (pdpu_rt_fields fills them).  kWide: S6 in a 64-bit word (FW = 31)
// where the magnitude's bits and the scale range do not fit 32.
struct PdpuRTFields {
  int NI, NO, ES, FBI, FBO, CPL, CPR, CAL, CAR, SCALE0, FW, MAXS;
  uint32_t STM;  // 1 when sticky, else 0
};

template <int N_, bool WIDE_>
struct PdpuRT : PdpuRTFields {
  static constexpr bool kFixed = false, kWide = WIDE_;
  static constexpr int N = N_;
  static constexpr int SENT = -(1 << 20);
};

// Host side: the fields of a configuration (n_in / n_out bits, one es).
// Returns 1 when S6's word is 32 bits, 2 when it needs 64 (FW 31), 0 when
// the configuration breaks the datapath's bounds (pdpu._validate's: the
// products and the sum of N + 1 terms in 31 bits), or a format is not one
// of at most 16 bits with es <= 4.
inline int pdpu_rt_fields(PdpuRTFields& f, int n_in, int n_out, int es,
                          int N, int w_m, int G, int sticky) {
  if (n_in < 3 || n_in > 16 || n_out < 3 || n_out > 16 || es < 0 ||
      es > 4 || N < 1 || w_m < 1 || G < 0)
    return 0;
  f.NI = n_in;
  f.NO = n_out;
  f.ES = es;
  f.FBI = n_in - 3 - es > 0 ? n_in - 3 - es : 0;
  f.FBO = n_out - 3 - es > 0 ? n_out - 3 - es : 0;
  const int cp = w_m - 2 - 2 * f.FBI + G, ca = w_m - 2 - f.FBO + G;
  f.CPL = cp > 0 ? cp : 0;
  f.CPR = cp < 0 ? cp : 0;
  f.CAL = ca > 0 ? ca : 0;
  f.CAR = ca < 0 ? -ca : 0;
  f.SCALE0 = 2 - w_m - G;
  f.MAXS = (n_out - 2) << es;
  f.STM = sticky ? 1u : 0u;
  if (w_m + G > 29) return 0;
  const long long magmax = (long long)(N + 1) << (w_m + G);
  if (2 * f.FBI + 2 + f.CPL > 31 || f.FBO + 1 + f.CAL > 31 ||
      magmax >= (1LL << 31))
    return 0;
  // FW fraction bits below the magnitude's leading one (all of its bits),
  // and at least FBO + 1 (S6 rounds below the word's scale)
  int fw = 0;
  while ((1LL << (fw + 1)) < magmax) ++fw;
  if (fw < f.NO - 2 - es) fw = f.NO - 2 - es;
  if (fw <= 29 && f.MAXS + 1 < (1 << (30 - fw))) {
    f.FW = fw;
    return 1;
  }
  f.FW = 31;
  return 2;
}

// An operand code (low NI bits of the int16 container) -> its fields.
// d is scale + offset (A carries the products' CPR); nar is set for
// the NaR code, whose fields are a zero's.
template <class P>
__device__ __forceinline__ void pdpu_operand(const P& p, uint32_t code,
                                             int offset, uint32_t& f, int& d,
                                             uint32_t& m, bool& nar) {
  const uint32_t xu = code << (32 - p.NI);
  const uint32_t s = (uint32_t)((int32_t)xu >> 31);
  const uint32_t body = ((xu ^ s) - s) << 1;  // |x| without its sign bit
  const int32_t rs = (int32_t)body >> 31;
  const int run = __clz((int32_t)body ^ rs);
  const int k = (-run) ^ rs;
  const uint32_t rem = __funnelshift_lc(0u, body, run) << 1;
  // shifts by 32 - ES and 32 - FBI clamp to 0 bits for ES = 0 / FBI = 0
  const int scale =
      k * (1 << p.ES) + (int)__funnelshift_rc(rem, 0u, 32 - p.ES);
  const uint32_t frac =
      (1u << p.FBI) | __funnelshift_rc(rem << p.ES, 0u, 32 - p.FBI);
  f = body != 0u ? frac : 0u;
  d = body != 0u ? scale + offset : P::SENT;
  m = body != 0u ? s : 0u;
  nar = body == 0u && s != 0u;
}

// The accumulator between chunk steps: sig = its significand << CAL (0 for
// zero), ec its scale (SENT for zero), neg its sign mask.
struct PdpuAcc {
  uint32_t sig;
  int ec;
  uint32_t neg;
};

// S3 for one term: shift right by r (clamped at 32), the dropped bits'
// OR into the LSB when sticky, then xor the sign mask.
template <class P>
__device__ __forceinline__ uint32_t pdpu_term(const P& p, uint32_t v,
                                              uint32_t r, uint32_t m) {
  uint32_t t = __funnelshift_rc(v, 0u, r);
  const uint32_t dropped = __funnelshift_rc(0u, v, r);
  uint32_t st;  // min(dropped, 1) as one VIMNMX, not a compare and select
#ifdef __CUDA_ARCH__
  asm("min.u32 %0, %1, 1;" : "=r"(st) : "r"(dropped));
#else
  st = min(dropped, 1u);
#endif
  if constexpr (P::kFixed) {
    if (P::STICKY) t |= st;
  } else {
    t |= st & p.STM;
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
// multiple of 2^ES in S, no tie possible).  Returns the rounded scale and
// the significand << CAL.
template <class P>
__device__ __forceinline__ void pdpu_round(const P& p, int S, uint32_t L,
                                           int& ec, uint32_t& sig) {
  const int Sc = min(max(S, -p.MAXS - 1), p.MAXS);
  const int k = Sc >> p.ES;
  const int m = k ^ (k >> 31);                        // rlen = m + 2
  const int flip = m >= p.NO - 3;                     // n_avail 0
  if constexpr (P::kWide) {
    const int D = p.ES + 31 - p.NO + 3 + m;
    const long long Y = (long long)Sc * (1LL << 31) + (long long)(L & 0x7FFFFFFFu);
    const long long lsb = ((Y >> D) ^ flip) & 1;
    const long long Yr = ((Y + (1LL << (D - 1)) - 1 + lsb) >> D) << D;
    ec = (int)(Yr >> 31);
    sig = (uint32_t)(((Yr & 0x7FFFFFFFLL) | (1LL << 31)) >>
                     (31 - p.FBO - p.CAL));
  } else {
    const int FW = p.FW;
    const int D = p.ES + FW - p.NO + 3 + m;
    const int Y = (int)((uint32_t)Sc << FW) | (int)((L << 1) >> (32 - FW));
    const int lsb = ((Y >> D) ^ flip) & 1;
    const int Yr = ((Y + (1 << (D - 1)) - 1 + lsb) >> D) << D;
    ec = Yr >> FW;
    sig = (((uint32_t)Yr & ((1u << FW) - 1u)) | (1u << FW)) >>
          (FW - p.FBO - p.CAL);
  }
}

// One chunk step: acc <- round(acc + sum of N products).  v: the exact
// products << CPL, d: their exponent fields (scale_a + scale_b + CPR, or
// below SENT for a zero product), m: their sign masks, ep: max of d minus
// CPR (the products' exponent max), nneg: the number of negative
// products.  Everything but acc is independent of the chain.
template <class P>
__device__ __forceinline__ void pdpu_step(const P& p, PdpuAcc& acc,
                                          const uint32_t* v, const int* d,
                                          const uint32_t* m, int ep,
                                          int nneg) {
  const int e = max(ep, acc.ec);  // S2's comparator tree, the last level
  // S3 + S4: the aligned terms' sum; -x = (x ^ ~0) + 1
  int s = nneg - (int)acc.neg;
#pragma unroll
  for (int i = 0; i < P::N; ++i)
    s += (int)pdpu_term(p, v[i], (uint32_t)(e - d[i]), m[i]);
  s += (int)pdpu_term(p, acc.sig, (uint32_t)(e - acc.ec + p.CAR), acc.neg);
  // S5: magnitude, leading one, final scale; S6: one rounding
  const uint32_t mag = (uint32_t)(s < 0 ? -s : s);
  const int z = __clz((int)mag);
  int ec;
  uint32_t sig;
  pdpu_round(p, e + p.SCALE0 + 31 - z, mag << (z & 31), ec, sig);
  acc.neg = (uint32_t)(s >> 31);
  acc.ec = mag != 0u ? ec : P::SENT;
  acc.sig = mag != 0u ? sig : 0u;
}

// The products of one chunk for one output: fields of A's row and B's
// column -> what pdpu_step takes.
template <class P>
__device__ __forceinline__ void pdpu_products(
    const P& p, const uint32_t* fa, const int* da, const uint32_t* ma,
    const uint32_t* fb, const int* db, const uint32_t* mb, uint32_t* v,
    int* d, uint32_t* m, int& ep, int& nneg) {
  ep = P::SENT * 2;
  nneg = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    v[i] = (fa[i] * fb[i]) << p.CPL;
    d[i] = da[i] + db[i];
    m[i] = ma[i] ^ mb[i];
    ep = max(ep, d[i]);
    nneg -= (int)m[i];
  }
  ep -= p.CPR;
}

// The output code of an accumulator: its fmt_out code in [0, 2^NO) (the
// value is a posit of fmt_out, so the rounding only packs it).
template <class P>
__device__ __forceinline__ uint32_t pdpu_code(const P& p,
                                              const PdpuAcc& acc) {
  const uint32_t L = acc.sig << (31 - p.FBO - p.CAL);
  uint32_t c;
  if constexpr (P::kFixed)
    c = posit_round_abs<P::NO, P::ES>(acc.ec, L);
  else
    c = posit_round_abs_rt(p.NO, p.ES, acc.ec, L);
  return acc.sig != 0u ? ((c ^ acc.neg) - acc.neg) & ((1u << p.NO) - 1u)
                       : 0u;
}
