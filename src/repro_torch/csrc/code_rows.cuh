// Weight-code decoders and row loaders shared by the GEMV-shaped kernels
// (K6's split-K GEMV, K9's grouped GEMV, K4's head GEMM).
//
// DecodeRuntime decodes a format given at run time (posit_decode, about 30
// integer operations a code); DecodeP16_2 is the compile-time P(16,2)
// decode (posit_decode_fast<16, 2>, about 17).  A kernel takes one of them
// as a template argument, so each variant compiles its own inner loop.
// Both ignore the bits of a code word above its format's n.
#pragma once

#include <cstdint>

#include "posit.cuh"

struct DecodeRuntime {
  int n, es;
  __device__ __forceinline__ float operator()(uint32_t c) const {
    return posit_decode(c, n, es);
  }
};

struct DecodeP16_2 {
  __device__ __forceinline__ float operator()(uint32_t c) const {
    return posit_decode_fast<16, 2>(c);
  }
};

constexpr int kCols = 8;  // weight elements a thread reads per row

// element j of a run of packed elements, in the low bits (the decoders
// ignore the bits above their width)
template <typename T>
__device__ __forceinline__ uint32_t elem(const uint32_t* w, int j) {
  if constexpr (sizeof(T) == 4) return w[j];
  else if constexpr (sizeof(T) == 2) return (j & 1) ? w[j >> 1] >> 16 : w[j >> 1];
  else return w[j >> 2] >> (8 * (j & 3));
}

// the raw bits of one element (float weights travel as their bits)
template <typename T>
__device__ __forceinline__ uint32_t raw_bits(T v) {
  if constexpr (sizeof(T) == 4) return __float_as_uint(v);
  else if constexpr (sizeof(T) == 2) return (uint16_t)v;
  else return (uint8_t)v;
}

// kCols consecutive elements of one weight row (int8 / int16 codes, f32,
// or bf16 bits as uint16_t) as raw words: one 8-, 16- or 2 x 16-byte load
// where the row is aligned and whole, element by element at a ragged edge
// (elements past ncols read as 0).
template <typename T>
struct Row8 {
  static constexpr int kWords = kCols * (int)sizeof(T) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const T* __restrict__ p, int ncols,
                                       bool vec) {
    if (vec && ncols >= kCols) {
      if constexpr (kWords == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = v.x; w[1] = v.y;
      } else {
#pragma unroll
        for (int h = 0; h < kWords / 4; ++h) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + h);
          w[4 * h] = v.x; w[4 * h + 1] = v.y; w[4 * h + 2] = v.z;
          w[4 * h + 3] = v.w;
        }
      }
      return;
    }
    zero();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (j >= ncols) break;
      const uint32_t b = raw_bits(p[j]);
      if constexpr (sizeof(T) == 4) w[j] = b;
      else if constexpr (sizeof(T) == 2) w[j >> 1] |= b << (16 * (j & 1));
      else w[j >> 2] |= b << (8 * (j & 3));
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ uint32_t code(int j) const { return elem<T>(w, j); }
};
