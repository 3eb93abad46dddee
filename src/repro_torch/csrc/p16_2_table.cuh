// The float GEMV's P(16,2) decode: a 512-entry table over the code's top
// 9 bits, one FFMA a code, bitwise posit_decode_fast<16, 2>.
//
// A P(16,2) code u (16 bits, sign included) splits into idx = u >> 7 and
// its 7 low bits lo7.  Wherever the regime run is at most 5 bits the
// sign, regime and exponent sit in idx's bits and lo7 is pure fraction,
// so over the 128 codes of one idx the value is linear: V0 + lo7 * step.
// That holds for negative codes too (two's complement maps the 128 codes
// of idx onto the magnitudes just below the next idx's), so no |u| and no
// sign operation is needed.  The kernel forms
//     m = the f32 whose bits are 0x3F000000 | (u & 0xFF) << 16
//       = 2^(b - 1) (1 + lo7 / 128),   b = idx & 1 (bit 7 of u)
// with one PRMT, and value = fmaf(m, T, B), T = 128 step / 2^(b - 1) and
// B = V0 - 128 step.  m T is exact and the exact sum is the value (at most
// 13 significant bits), so the FMA's rounding changes nothing.  T is a
// power of two and B has at most 7 significant bits, so both are exact in
// bf16: an entry is one 32-bit word, B's bf16 bits in the high half and
// T's in the low (posit_matmul.gemv_f_p16_2_table(), built on the host
// from the port's decode).  A code costs the index (a shift and a mask),
// one PRMT, one 4-byte shared-memory load, the two halves (a mask and a
// shift) and one FFMA; its sign costs nothing.  4-byte entries keep a
// warp's 32 lookups to about two shared-memory wavefronts (8-byte entries
// took about twice that: scripts/time_gemv_decode.py).
//
// The 16 idx whose run is 6 or more (zero, NaR and the magnitudes beyond
// 2^-20 and 2^20: 2048 of the 65536 codes) hold B = nan and bit 0 set.  A
// lane ORs its 8 entries (3 LOP3s), and where any lane of the warp finds
// bit 0 the warp decodes those 8 codes again with posit_decode_fast<16,
// 2> (a warp-uniform branch): free where no lane needs it, bitwise where
// one does.
#pragma once

#include <cstdint>

#include "code_rows.cuh"
#include "posit.cuh"

constexpr int kP16_2TableEntries = 512;  // 32-bit entries, 2 KB

// the entry of the code in bits 0-15 (lo) or 16-31 (hi) of w
__device__ __forceinline__ uint32_t p16_2_entry_lo(const uint32_t* tab,
                                                   uint32_t w) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(tab) + ((w >> 5) & 0x7FCu));
}
__device__ __forceinline__ uint32_t p16_2_entry_hi(const uint32_t* tab,
                                                   uint32_t w) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(tab) + ((w >> 21) & 0x7FCu));
}

// the value of a code from its entry e and m's bits
__device__ __forceinline__ float p16_2_table_value(uint32_t e, uint32_t m) {
  return fmaf(__uint_as_float(m), __uint_as_float(e << 16),
              __uint_as_float(e & 0xFFFF0000u));
}

// e[0] | ... | e[7] in three LOP3s (written out: left to itself the
// compiler tests each entry's bit 0 on its own)
__device__ __forceinline__ uint32_t or8(const uint32_t (&e)[kCols]) {
  uint32_t a, b, c;
  asm("lop3.b32 %0, %1, %2, %3, 0xFE;" : "=r"(a) : "r"(e[0]), "r"(e[1]), "r"(e[2]));
  asm("lop3.b32 %0, %1, %2, %3, 0xFE;" : "=r"(b) : "r"(e[3]), "r"(e[4]), "r"(e[5]));
  asm("lop3.b32 %0, %1, %2, %3, 0xFE;" : "=r"(c) : "r"(a), "r"(b), "r"(e[6]));
  return c | e[7];
}

// Row decoders of the float GEMV: v[j] = the value of code j of a Row8.
// kTableEntries is the size of the decoder's 32-bit table (0: none); the
// kernel copies the table into shared memory and calls init().

// int16 P(16,2) codes by the table, the rare long-run codes by
// posit_decode_fast<16, 2>.  The long-run entries have bit 0 set (T's
// bf16 bits 0x0001; every other T is a power of two, its low bits 0), so
// one OR of a row's 8 entries says whether the warp votes for the full
// decode.  Every lane of the warp must call row().
struct DecodeP16_2Table {
  static constexpr int kTableEntries = kP16_2TableEntries;
  const uint32_t* tab;  // in shared memory
  uint32_t one_hi;      // 0x3F000000, held in a register
  // zero: a run-time 0 the compiler cannot fold, so that one_hi stays in
  // a register and each PRMT takes its selector as an immediate
  __device__ __forceinline__ void init(const uint32_t* shared_tab,
                                       uint32_t zero) {
    tab = shared_tab;
    one_hi = 0x3F000000u | zero;
  }
  __device__ __forceinline__ void row(const Row8<int16_t>& r,
                                      float (&v)[kCols]) const {
    uint32_t e[kCols];
#pragma unroll
    for (int h = 0; h < kCols / 2; ++h) {
      e[2 * h] = p16_2_entry_lo(tab, r.w[h]);
      e[2 * h + 1] = p16_2_entry_hi(tab, r.w[h]);
    }
#pragma unroll
    for (int h = 0; h < kCols / 2; ++h) {
      v[2 * h] = p16_2_table_value(e[2 * h],
                                   __byte_perm(r.w[h], one_hi, 0x7044));
      v[2 * h + 1] = p16_2_table_value(e[2 * h + 1],
                                       __byte_perm(r.w[h], one_hi, 0x7244));
    }
    if (__any_sync(0xffffffffu, or8(e) & 1u)) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        v[j] = posit_decode_fast<16, 2>(r.code(j));
    }
  }
};

// any code decoder of code_rows.cuh, code by code
template <typename Dec>
struct DecodeEach {
  static constexpr int kTableEntries = 0;
  Dec dec;
  __device__ __forceinline__ void init(const uint32_t*, uint32_t) {}
  template <typename BT>
  __device__ __forceinline__ void row(const Row8<BT>& r,
                                      float (&v)[kCols]) const {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = dec(r.code(j));
  }
};
