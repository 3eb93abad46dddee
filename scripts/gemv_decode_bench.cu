// Decode candidates for the float GEMV's int16 P(16,2) weights, each
// timed alone: every thread decodes 8 codes a 16-byte load (4 loads in
// flight, read from L1 / L2, not HBM) and feeds each value to 4 FMAs, as
// the GEMV does at M 4.  Built and run by scripts/time_gemv_decode.py.
//
//   fast17    posit_decode_fast<16, 2> (csrc/posit.cuh): the parent's decode
//   table512  DecodeP16_2Table (csrc/p16_2_table.cuh), the GEMV's: a
//             32-bit entry (two bf16) by the code's top 9 bits, sign
//             included; one PRMT, one LDS.32, two unpacking operations,
//             one FFMA a code; long-run codes by posit_decode_fast behind a
//             warp vote
//   table512x8  the same with 8-byte f32 (base, step) entries: one LDS.64,
//             no unpacking
//   table256  (base, step) by the top 8 bits of |code|'s 15-bit body:
//             IABS first, the sign put back with one LOP3; the same vote
//   table32k  f32 magnitudes of all 2^15 + 1 |code| values (128 KB of
//             shared memory, one block an SM), the sign put back
//
// All five are bitwise posit_decode_fast<16, 2> on every code
// (gemv_decode_check_kernel).
#include <cuda_runtime.h>

#include <cstdint>

#include "code_rows.cuh"
#include "p16_2_table.cuh"
#include "posit.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t lo16(uint32_t w) { return w & 0xFFFFu; }
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w >> 16; }

struct Fast17 {
  static constexpr int kSmemBytes = 0;
  __device__ void init(float4*, uint32_t) {}
  __device__ __forceinline__ void row(const Row8<int16_t>& r,
                                      float (&v)[kCols]) const {
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = posit_decode_fast<16, 2>(r.code(j));
  }
};

// the table of p16_2_table.cuh, built here from posit_decode_fast (the
// same bits as posit_matmul.gemv_f_p16_2_table())
struct Table512 {
  static constexpr int kSmemBytes = kP16_2TableEntries * 4;
  DecodeP16_2Table dec;
  __device__ void init(float4* smem, uint32_t zero) {
    uint32_t* t = reinterpret_cast<uint32_t*>(smem);
    for (int i = threadIdx.x; i < kP16_2TableEntries; i += kThreads) {
      const float v0 = posit_decode_fast<16, 2>((uint32_t)i << 7);
      const float step = posit_decode_fast<16, 2>(((uint32_t)i << 7) + 1) - v0;
      const float b = v0 - 128.0f * step;
      const float tt = 128.0f * step * ((i & 1) ? 1.0f : 2.0f);
      const bool slow = ((i + 4) & 0xFF) < 8;
      t[i] = slow ? 0x7FC00001u
                  : ((__float_as_uint(b) & 0xFFFF0000u) |
                     (__float_as_uint(tt) >> 16));
    }
    dec.init(t, zero);
  }
  __device__ __forceinline__ void row(const Row8<int16_t>& r,
                                      float (&v)[kCols]) const {
    dec.row(r, v);
  }
};

// the same decode from 8-byte (base, step) f32 entries: one LDS.64, no
// unpacking, base = V0 - (2^23 + 128 b) step, m = 2^23 + (u & 0xFF)
struct Table512x8 {
  static constexpr int kSmemBytes = kP16_2TableEntries * 8;
  const float2* tab;
  __device__ void init(float4* smem, uint32_t zero) {
    float2* t = reinterpret_cast<float2*>(smem);
    for (int i = threadIdx.x; i < kP16_2TableEntries; i += kThreads) {
      const float v0 = posit_decode_fast<16, 2>((uint32_t)i << 7);
      const float step = posit_decode_fast<16, 2>(((uint32_t)i << 7) + 1) - v0;
      const bool slow = ((i + 4) & 0xFF) < 8;
      t[i] = slow ? make_float2(__uint_as_float(0x7FC00000u), 0.0f)
                  : make_float2(v0 - (8388608.0f + 128.0f * (i & 1)) * step,
                                step);
    }
    tab = t;
  }
  __device__ __forceinline__ void row(const Row8<int16_t>& r,
                                      float (&v)[kCols]) const {
    const char* t = reinterpret_cast<const char*>(tab);
#pragma unroll
    for (int h = 0; h < kCols / 2; ++h) {
      const uint32_t w = r.w[h];
      const float2 e0 = *reinterpret_cast<const float2*>(t + ((w >> 4) & 0xFF8u));
      const float2 e1 = *reinterpret_cast<const float2*>(t + ((w >> 20) & 0xFF8u));
      v[2 * h] = fmaf(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)),
                      e0.y, e0.x);
      v[2 * h + 1] = fmaf(
          __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)), e1.y, e1.x);
    }
    const float chk =
        ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
    if (__any_sync(0xffffffffu, chk != chk)) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        v[j] = posit_decode_fast<16, 2>(r.code(j));
    }
  }
};

// (base, step) by body >> 7 of the 15-bit body of |code|
struct Table256 {
  static constexpr int kSmemBytes = 256 * 8;
  const float2* tab;
  __device__ void init(float4* smem, uint32_t zero) {
    float2* t = reinterpret_cast<float2*>(smem);
    for (int i = threadIdx.x; i < 256; i += kThreads) {
      const float v0 = posit_decode_fast<16, 2>((uint32_t)i << 7);
      const float step = posit_decode_fast<16, 2>(((uint32_t)i << 7) + 1) - v0;
      const bool slow = ((i + 4) & 0xFF) < 8;
      t[i] = slow ? make_float2(__uint_as_float(0x7FC00000u), 0.0f)
                  : make_float2(v0 - 8388608.0f * step, step);
    }
    tab = t;
  }
  __device__ __forceinline__ float one(uint32_t c16) const {
    const int32_t c = (int32_t)(c16 << 16) >> 16;
    const uint32_t a = (uint32_t)abs(c);  // 0 .. 32768
    const float2 e = tab[(a >> 7) & 0xFFu];
    const float m = __uint_as_float(0x4B000000u | (a & 0x7Fu));
    // NaR (a = 32768) indexes entry 0: slow, decoded in full
    return __uint_as_float(__float_as_uint(fmaf(m, e.y, e.x)) ^
                           ((uint32_t)c & 0x80000000u));
  }
  __device__ __forceinline__ void row(const Row8<int16_t>& r,
                                      float (&v)[kCols]) const {
#pragma unroll
    for (int h = 0; h < kCols / 2; ++h) {
      v[2 * h] = one(lo16(r.w[h]));
      v[2 * h + 1] = one(hi16(r.w[h]));
    }
    const float chk =
        ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
    if (__any_sync(0xffffffffu, chk != chk)) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        v[j] = posit_decode_fast<16, 2>(r.code(j));
    }
  }
};

// every |code| value, 0 .. 32768 (NaR's entry nan)
struct Table32k {
  static constexpr int kEntries = (1 << 15) + 1;
  static constexpr int kSmemBytes = ((kEntries * 4 + 15) / 16) * 16;
  const float* tab;
  __device__ void init(float4* smem, uint32_t zero) {
    float* t = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < kEntries; i += kThreads)
      t[i] = posit_decode_fast<16, 2>((uint32_t)i);
    tab = t;
  }
  __device__ __forceinline__ float one(uint32_t c16) const {
    const int32_t c = (int32_t)(c16 << 16) >> 16;
    const float v = tab[abs(c)];
    return __uint_as_float(__float_as_uint(v) ^ ((uint32_t)c & 0x80000000u));
  }
  __device__ __forceinline__ void row(const Row8<int16_t>& r,
                                      float (&v)[kCols]) const {
#pragma unroll
    for (int h = 0; h < kCols / 2; ++h) {
      v[2 * h] = one(lo16(r.w[h]));
      v[2 * h + 1] = one(hi16(r.w[h]));
    }
  }
};

// codes [slice of 8192 words a block] decoded `passes` times, 4 FMAs a
// value; out[thread] keeps the sums live
template <typename Cand>
__global__ void __launch_bounds__(kThreads) gemv_decode_bench_kernel(
    const uint4* __restrict__ codes, int slices, int passes,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  Cand cand;
  cand.init(smem4, (uint32_t)passes >> 31);  // a run-time 0
  __syncthreads();
  const uint4* p = codes + (size_t)(blockIdx.x % slices) * 2048;
  const float x0 = 1.0f + threadIdx.x, x1 = 0.5f, x2 = -0.25f, x3 = 2.0f;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 1
  for (int it = 0; it < passes; ++it) {
#pragma unroll 1
    for (int i = threadIdx.x; i < 2048; i += 4 * kThreads) {
      Row8<int16_t> w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 q = __ldg(p + i + u * kThreads);
        w[u].w[0] = q.x; w[u].w[1] = q.y; w[u].w[2] = q.z; w[u].w[3] = q.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[kCols];
        cand.row(w[u], v);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          a0 = fmaf(x0, v[j], a0);
          a1 = fmaf(x1, v[j], a1);
          a2 = fmaf(x2, v[j], a2);
          a3 = fmaf(x3, v[j], a3);
        }
      }
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = (a0 + a1) + (a2 + a3);
}

// every one of the 2^16 codes through the candidate: out[c] = its value
template <typename Cand>
__global__ void __launch_bounds__(kThreads) gemv_decode_check_kernel(
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  Cand cand;
  cand.init(smem4, 0u);
  __syncthreads();
  const int base = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  Row8<int16_t> w;
#pragma unroll
  for (int h = 0; h < 4; ++h)
    w.w[h] = (uint32_t)(base + 2 * h) | ((uint32_t)(base + 2 * h + 1) << 16);
  float v[kCols];
  cand.row(w, v);
#pragma unroll
  for (int j = 0; j < kCols; ++j) out[base + j] = v[j];
}

template <typename Cand>
int run(int which, const void* codes, int slices, int blocks, int passes,
        float* out, cudaStream_t s) {
  const int smem = Cand::kSmemBytes;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gemv_decode_bench_kernel<Cand>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(gemv_decode_check_kernel<Cand>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (which == 0)
    gemv_decode_check_kernel<Cand><<<(1 << 16) / (kThreads * kCols),
                                     kThreads, smem, s>>>(out);
  else
    gemv_decode_bench_kernel<Cand><<<blocks, kThreads, smem, s>>>(
        static_cast<const uint4*>(codes), slices, passes, out);
  return (int)cudaGetLastError();
}

}  // namespace

// cand: 0 fast17, 1 table512, 2 table256, 3 table32k, 4 table512x8.  which 0: decode
// all 2^16 codes into out[65536]; 1: the timed loop over `blocks` blocks,
// each over one of `slices` slices of 8192 code words, `passes` times
// (out: blocks * 256 floats).
extern "C" int gemv_decode_bench(int cand, int which, const void* codes,
                                 int slices, int blocks, int passes,
                                 void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (cand) {
    case 0: return run<Fast17>(which, codes, slices, blocks, passes, o, s);
    case 1: return run<Table512>(which, codes, slices, blocks, passes, o, s);
    case 2: return run<Table256>(which, codes, slices, blocks, passes, o, s);
    case 3: return run<Table32k>(which, codes, slices, blocks, passes, o, s);
    case 4: return run<Table512x8>(which, codes, slices, blocks, passes, o, s);
  }
  return -1;
}
