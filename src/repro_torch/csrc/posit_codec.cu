// Elementwise posit codec kernels: K1 posit_decode and K2 posit_encode.
//
// Replaces the TPU kernels src/repro/kernels/posit_codec.py:decode
// (_decode_kernel) and src/repro/kernels/posit_codec.py:encode
// (_encode_kernel), which tile the input as 2-D (block_r, block_c) VMEM
// blocks over a sequential grid.
//
// Bound on an H100: memory.  Decode reads 2 bytes (int16) or 1 byte (int8)
// and writes 4 bytes per element; encode reads 4 and writes 1 or 2.  At
// those rates an SM must finish about 2.4 int16 codes a clock, so the
// codec's integer operations (some 30 an element for the run-time decode,
// about 17 for a compile-time one, on 64 integer lanes an SM) are of the
// same order as the bytes: the design keeps the instruction count per byte
// low rather than adding stages:
//   * a flat grid-stride loop (no 2-D tiling: the op is elementwise and the
//     flattened layout is what the memory system wants),
//   * the run-time kernels (the `posit` variants, any n <= 16) take one
//     16-byte vector of the narrower side a thread (8 int16 or 16 int8
//     codes) when both pointers are 16-byte aligned, with a scalar loop for
//     the tail and for unaligned views.
//
// The float weight path no longer runs K1 at decode rows: a GEMV that
// decodes each weight code next to its dot (csrc/posit_gemv_f.cu) takes
// M <= 8.  K1 keeps what decodes a whole operand: prefill chunk groups
// and training (M > 8), the heads, bit_exact's fmt_out codes, the dense
// KV cache's rows and the speculative draft's fake_quant weights.
//
// K1's compile-time variants (p16_2, p13_2 from int16, p8_2 from int8;
// posit_decode_fast_kernel) cover every format those paths decode.  They
// decode with posit_decode_fast<N, ES> (posit.cuh) and issue all of a
// lane's loads of a tile before the first decode: a lane reads 4
// consecutive codes a load (8 bytes of int16, 4 of int8; each load
// coalesced across the warp), 32 bytes in flight, and writes their 4
// values as one 16-byte store, coalesced across the warp.  Every tile has
// a warp of its own.  On an H100 at [8192, 22528] this layout took
// 0.376 ms (88% of the bytes bound) where 16-byte loads with two 16-byte
// stores 32 bytes apart across the warp took 0.46-0.67, 64 bytes in
// flight 0.386, and one wave of resident blocks walking the tiles 0.40
// (PERF.md).  The run-time kernel stays as the `posit` variant for every
// other format.
//
// K2's compile-time variants (p16_2, p13_2 into int16, p8_2 into int8;
// posit_encode_fast_kernel) are what every main path encodes: the tied
// head's re-encode, activations, KV pages.  The run-time encode builds its
// body in 64-bit integers, which the SM emulates with 32-bit pairs: some
// 50 instructions an element, so at [256000, 8192] the integer pipe (about
// 6 ms) and not HBM (3.76 ms) bounds it.  The variants round in one 32-bit
// word (posit_round_abs in posit.cuh: the pattern is one arithmetic
// shift, saturation a clamp of the scale) and issue a lane's four 16-byte
// loads, each coalesced across its warp, before the first encode: 64
// bytes in flight a thread.  A float4's 4 codes leave as one 8-byte
// (int16) or 4-byte (int8) store, coalesced across the warp; 16-byte
// stores (8 consecutive codes a lane) need loads 64 bytes apart across
// the warp, which measured slower.  The run-time kernel stays as the
// `posit` variant for every other format.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "posit.cuh"

namespace {

template <typename CT>
union CodeVec {
  uint4 raw;
  CT c[16 / sizeof(CT)];
};

template <typename CT>
__global__ void posit_decode_kernel(const CT* __restrict__ in,
                                    float* __restrict__ out, long long count,
                                    int n, int es, int vec) {
  constexpr int V = 16 / sizeof(CT);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long groups = count / V;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long g = tid; g < groups; g += stride) {
      CodeVec<CT> cv;
      cv.raw = __ldg(in4 + g);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        float4 o;
        o.x = posit_decode((uint32_t)(int)cv.c[j + 0], n, es);
        o.y = posit_decode((uint32_t)(int)cv.c[j + 1], n, es);
        o.z = posit_decode((uint32_t)(int)cv.c[j + 2], n, es);
        o.w = posit_decode((uint32_t)(int)cv.c[j + 3], n, es);
        out4[g * (V / 4) + j / 4] = o;
      }
    }
    done = groups * V;
  }
  for (long long i = done + tid; i < count; i += stride) {
    out[i] = posit_decode((uint32_t)(int)in[i], n, es);
  }
}

// A warp decodes tiles of J x 32 loads of 4 codes: lane l reads load
// 32 j + l of its tile (j < J; each load coalesced across the warp, all J
// issued before the first decode: 32 bytes a lane) and writes its 4 values
// as one 16-byte store, coalesced across the warp.  The grid gives every
// tile a warp of its own; the loop serves a grid the launcher capped.
template <typename CT, int N, int ES>
__global__ void posit_decode_fast_kernel(const CT* __restrict__ in,
                                         float* __restrict__ out,
                                         long long count, int vec) {
  constexpr int J = 32 / (4 * (int)sizeof(CT));  // 4 (int16), 8 (int8)
  using Pack = typename std::conditional<sizeof(CT) == 2, uint2,
                                         uint32_t>::type;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const int lane = threadIdx.x & 31;
    const long long tiles = count / (128 * J);
    const Pack* inp = reinterpret_cast<const Pack*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long t = tid >> 5; t < tiles; t += stride >> 5) {
      Pack p[J];
#pragma unroll
      for (int j = 0; j < J; ++j) p[j] = __ldg(inp + (t * J + j) * 32 + lane);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        uint32_t c[4];
        if constexpr (sizeof(CT) == 2) {
          c[0] = p[j].x; c[1] = p[j].x >> 16; c[2] = p[j].y;
          c[3] = p[j].y >> 16;
        } else {
          c[0] = p[j]; c[1] = p[j] >> 8; c[2] = p[j] >> 16; c[3] = p[j] >> 24;
        }
        out4[(t * J + j) * 32 + lane] = make_float4(
            posit_decode_fast<N, ES>(c[0]), posit_decode_fast<N, ES>(c[1]),
            posit_decode_fast<N, ES>(c[2]), posit_decode_fast<N, ES>(c[3]));
      }
    }
    done = tiles * 128 * J;
  }
  for (long long i = done + tid; i < count; i += stride) {
    out[i] = posit_decode_fast<N, ES>((uint32_t)(int)in[i]);
  }
}

template <typename CT>
__global__ void posit_encode_kernel(const float* __restrict__ in,
                                    CT* __restrict__ out, long long count,
                                    int n, int es, int vec) {
  constexpr int V = 16 / sizeof(CT);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long groups = count / V;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (long long g = tid; g < groups; g += stride) {
      CodeVec<CT> cv;
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 f = __ldg(in4 + g * (V / 4) + j / 4);
        cv.c[j + 0] = (CT)posit_encode(f.x, n, es);
        cv.c[j + 1] = (CT)posit_encode(f.y, n, es);
        cv.c[j + 2] = (CT)posit_encode(f.z, n, es);
        cv.c[j + 3] = (CT)posit_encode(f.w, n, es);
      }
      out4[g] = cv.raw;
    }
    done = groups * V;
  }
  for (long long i = done + tid; i < count; i += stride) {
    out[i] = (CT)posit_encode(in[i], n, es);
  }
}

// A warp encodes tiles of 4 x 32 float4: lane l reads float4 32 j + l of
// its tile (j < 4; each load coalesced across the warp, all four issued
// before the first encode) and writes that float4's 4 codes as one 8-byte
// (int16) or 4-byte (int8) store, coalesced across the warp.
template <typename CT, int N, int ES>
__global__ void posit_encode_fast_kernel(const float* __restrict__ in,
                                         CT* __restrict__ out,
                                         long long count, int vec) {
  constexpr int J = 4;  // float4 loads in flight a lane
  using Pack = typename std::conditional<sizeof(CT) == 2, uint2,
                                         uint32_t>::type;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const int lane = threadIdx.x & 31;
    const long long tiles = count / (128 * J);
    const float4* in4 = reinterpret_cast<const float4*>(in);
    Pack* outp = reinterpret_cast<Pack*>(out);
    for (long long t = tid >> 5; t < tiles; t += stride >> 5) {
      float4 f[J];
#pragma unroll
      for (int j = 0; j < J; ++j) f[j] = __ldg(in4 + (t * J + j) * 32 + lane);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint32_t c0 = posit_encode_fast<N, ES>(f[j].x);
        const uint32_t c1 = posit_encode_fast<N, ES>(f[j].y);
        const uint32_t c2 = posit_encode_fast<N, ES>(f[j].z);
        const uint32_t c3 = posit_encode_fast<N, ES>(f[j].w);
        Pack p;
        if constexpr (sizeof(CT) == 2) {
          p = make_uint2(c0 | (c1 << 16), c2 | (c3 << 16));
        } else {
          p = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
        }
        outp[(t * J + j) * 32 + lane] = p;
      }
    }
    done = tiles * 128 * J;
  }
  for (long long i = done + tid; i < count; i += stride) {
    out[i] = (CT)posit_encode_fast<N, ES>(in[i]);
  }
}

int grid_for(long long work) {
  long long blocks = (work + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return (int)blocks;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// variant: 0 the run-time format (n, es), 1 p16_2, 2 p13_2 (int16 codes),
// 3 p8_2 (int8 codes); a compile-time variant must match n, es and the
// container.
extern "C" int posit_decode_launch(const void* in, void* out, long long count,
                                   int code_bytes, int n, int es, int variant,
                                   void* stream) {
  const int vec = aligned16(in) && aligned16(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* y = (float*)out;
  if (variant != 0) {
    static const int want[4][3] = {{0, 0, 0}, {16, 2, 2}, {13, 2, 2},
                                   {8, 2, 1}};
    if (variant < 0 || variant > 3 || want[variant][0] != n ||
        want[variant][1] != es || want[variant][2] != code_bytes)
      return (int)cudaErrorInvalidValue;
    // a warp a tile of 128 J codes (J = 4 int16, 8 int8: 16 / 32 codes a
    // thread); the scalar path one element a thread
    long long threads = vec ? count * code_bytes / 32 : count;
    if (threads < 1) threads = 1;
    const long long blocks = (threads + 255) / 256;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = (int)blocks;
#define K1_FAST(CT, N, ES)                                                   \
  posit_decode_fast_kernel<CT, N, ES><<<grid, 256, 0, s>>>((const CT*)in, y, \
                                                            count, vec)
    if (variant == 1) {
      K1_FAST(int16_t, 16, 2);
    } else if (variant == 2) {
      K1_FAST(int16_t, 13, 2);
    } else {
      K1_FAST(int8_t, 8, 2);
    }
#undef K1_FAST
    return (int)cudaGetLastError();
  }
  if (code_bytes == 1) {
    posit_decode_kernel<int8_t><<<grid_for(vec ? count / 16 : count), 256, 0,
                                  s>>>((const int8_t*)in, y, count, n, es,
                                       vec);
  } else if (code_bytes == 2) {
    posit_decode_kernel<int16_t><<<grid_for(vec ? count / 8 : count), 256, 0,
                                   s>>>((const int16_t*)in, y, count, n, es,
                                        vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// variant: 0 the run-time format (n, es), 1 p16_2, 2 p13_2 (int16 codes),
// 3 p8_2 (int8 codes); a compile-time variant must match n, es and the
// container.
extern "C" int posit_encode_launch(const void* in, void* out, long long count,
                                   int code_bytes, int n, int es, int variant,
                                   void* stream) {
  const int vec = aligned16(in) && aligned16(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* x = (const float*)in;
  if (variant != 0) {
    static const int want[4][3] = {{0, 0, 0}, {16, 2, 2}, {13, 2, 2},
                                   {8, 2, 1}};
    if (variant < 0 || variant > 3 || want[variant][0] != n ||
        want[variant][1] != es || want[variant][2] != code_bytes)
      return (int)cudaErrorInvalidValue;
    const int grid = grid_for(vec ? count / 16 : count);
    if (variant == 1) {
      posit_encode_fast_kernel<int16_t, 16, 2><<<grid, 256, 0, s>>>(
          x, (int16_t*)out, count, vec);
    } else if (variant == 2) {
      posit_encode_fast_kernel<int16_t, 13, 2><<<grid, 256, 0, s>>>(
          x, (int16_t*)out, count, vec);
    } else {
      posit_encode_fast_kernel<int8_t, 8, 2><<<grid, 256, 0, s>>>(
          x, (int8_t*)out, count, vec);
    }
    return (int)cudaGetLastError();
  }
  if (code_bytes == 1) {
    posit_encode_kernel<int8_t><<<grid_for(vec ? count / 16 : count), 256, 0,
                                  s>>>(x, (int8_t*)out, count, n, es, vec);
  } else if (code_bytes == 2) {
    posit_encode_kernel<int16_t><<<grid_for(vec ? count / 8 : count), 256, 0,
                                   s>>>(x, (int16_t*)out, count, n, es, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
