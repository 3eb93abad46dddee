// Elementwise posit codec kernels: K1 posit_decode and K2 posit_encode.
//
// Replaces the TPU kernels src/repro/kernels/posit_codec.py:decode
// (_decode_kernel) and src/repro/kernels/posit_codec.py:encode
// (_encode_kernel), which tile the input as 2-D (block_r, block_c) VMEM
// blocks over a sequential grid.
//
// Bound on an H100: memory.  Decode reads 2 bytes (int16) or 1 byte (int8)
// and writes 4 bytes per element; encode reads 4 and writes 1 or 2.  The
// codec itself is ~25 integer instructions per element on the CUDA cores,
// which at int16 widths is of the same order as the bytes, so the design
// keeps the instruction count per byte low rather than adding stages:
//   * a flat grid-stride loop (no 2-D tiling: the op is elementwise and the
//     flattened layout is what the memory system wants),
//   * 16-byte loads and stores: each thread handles one 16-byte vector of
//     the narrower side (8 int16 or 16 int8 codes) when both pointers are
//     16-byte aligned, with a scalar loop for the tail and for unaligned
//     views,
//   * the format is a run-time argument, so one binary serves every n <= 16.
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

extern "C" int posit_decode_launch(const void* in, void* out, long long count,
                                   int code_bytes, int n, int es,
                                   void* stream) {
  const int vec = aligned16(in) && aligned16(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (code_bytes == 1) {
    posit_decode_kernel<int8_t><<<grid_for(vec ? count / 16 : count), 256, 0,
                                  s>>>((const int8_t*)in, (float*)out, count,
                                       n, es, vec);
  } else if (code_bytes == 2) {
    posit_decode_kernel<int16_t><<<grid_for(vec ? count / 8 : count), 256, 0,
                                   s>>>((const int16_t*)in, (float*)out,
                                        count, n, es, vec);
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
