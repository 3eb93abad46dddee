// K3 paged_attention: one decode query token per slot over block-table
// paged KV, with the posit decode of the pages done in the kernel.
//
// Replaces src/repro/kernels/paged_attention.py:paged_attention, 3-D q
// (_paged_attention_kernel).  On the TPU the grid is (slot, page) and the
// page axis runs in order, carrying the running max / normalizer / output
// in VMEM scratch.  Blocks on Hopper run in no order, so here one block
// owns one (slot, KV head) pair and loops over the slot's pages itself:
//   * it stages the page's codes for its head into shared memory and
//     decodes them there (each code is read from HBM and decoded once),
//   * it serves the G = Hq / Hkv query heads of the group from that one
//     decoded page (GQA reuse),
//   * the running max m, normalizer l and output o of the streaming
//     softmax live in shared memory for the whole page loop,
//   * masking follows the TPU kernel (paged_attention.py:93-102):
//     pos < length, (length - 1) - pos < window, page_ok[b, p] != 0.
//     Pages that are wholly masked contribute exactly nothing there
//     (corr = 1, p = 0), so they are skipped here without a change in
//     value.  A slot of length 0 yields finite zeros (or m = -2e38, l = 0
//     with partials).
//
// Bound on an H100: at serving shapes (B = 4 slots, 8 KV heads, Dh = 128,
// 16-token pages, a few hundred tokens) the whole call moves about 2 MB,
// under a microsecond of HBM time, so launch latency bounds it and a grid
// of B * Hkv blocks is enough.  Splitting long slots over several blocks
// (flash-decoding) is left for when contexts grow.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

constexpr float kNeg = -2.0e38f;

__device__ __forceinline__ float kv_value(int8_t c, int n, int es) {
  return posit_decode((uint32_t)(int)c, n, es);
}
__device__ __forceinline__ float kv_value(int16_t c, int n, int es) {
  return posit_decode((uint32_t)(int)c, n, es);
}
__device__ __forceinline__ float kv_value(float c, int, int) { return c; }
__device__ __forceinline__ float kv_value(__nv_bfloat16 c, int, int) {
  return __bfloat162float(c);
}

template <typename KT>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ lengths, const int* __restrict__ window,
    const int* __restrict__ page_ok, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int M, int ps,
    int Hq, int Hkv, int Dh, int n, int es, float scale, float softcap) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int F = Hkv * Dh;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [G][Dh], pre-scaled
  float* o_s = q_s + G * Dh;           // [G][Dh]
  float* k_s = o_s + G * Dh;           // [ps][Dh + 1] (padded rows)
  float* v_s = k_s + ps * (Dh + 1);    // [ps][Dh]
  float* p_s = v_s + ps * Dh;          // [G][ps] scores, then probabilities
  float* m_s = p_s + G * ps;           // [G]
  float* l_s = m_s + G;                // [G]
  float* c_s = l_s + G;                // [G] rescale factor of this page
  int* ok_s = reinterpret_cast<int*>(c_s + G);  // [G][ps] mask

  for (int i = tid; i < G * Dh; i += nthr) {
    const int g = i / Dh, d = i % Dh;
    q_s[i] = q[((size_t)b * Hq + h * G + g) * Dh + d] * scale;
    o_s[i] = 0.0f;
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }
  const int length = lengths[b];
  const long long q_pos = (long long)length - 1;
  const long long win = window[0];
  const int n_pages = length > 0 ? min(M, (length + ps - 1) / ps) : 0;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    if (page_ok != nullptr && page_ok[(size_t)b * M + p] == 0) continue;
    if ((long long)p * ps + ps - 1 <= q_pos - win) continue;  // out of window
    const size_t page = (size_t)bt[(size_t)b * M + p];
    const KT* kp = k_pages + page * ps * F + (size_t)h * Dh;
    const KT* vp = v_pages + page * ps * F + (size_t)h * Dh;
    for (int i = tid; i < ps * Dh; i += nthr) {
      const int t = i / Dh, d = i % Dh;
      k_s[t * (Dh + 1) + d] = kv_value(kp[(size_t)t * F + d], n, es);
      v_s[t * Dh + d] = kv_value(vp[(size_t)t * F + d], n, es);
    }
    __syncthreads();

    for (int i = tid; i < G * ps; i += nthr) {
      const int g = i / ps, t = i % ps;
      float acc = 0.0f;
      for (int d = 0; d < Dh; ++d) {
        acc = fmaf(q_s[g * Dh + d], k_s[t * (Dh + 1) + d], acc);
      }
      if (softcap > 0.0f) acc = softcap * tanhf(acc / softcap);
      const long long pos = (long long)p * ps + t;
      ok_s[i] = (pos < length) && (q_pos - pos < win);
      p_s[i] = acc;
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      float mx = m_s[g];
      for (int t = 0; t < ps; ++t) {
        if (ok_s[g * ps + t]) mx = fmaxf(mx, p_s[g * ps + t]);
      }
      float lsum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float pr = ok_s[g * ps + t] ? expf(p_s[g * ps + t] - mx) : 0.0f;
        p_s[g * ps + t] = pr;
        lsum += pr;
      }
      const float corr = expf(m_s[g] - mx);
      c_s[g] = corr;
      l_s[g] = l_s[g] * corr + lsum;
      m_s[g] = mx;
    }
    __syncthreads();

    for (int i = tid; i < G * Dh; i += nthr) {
      const int g = i / Dh, d = i % Dh;
      float acc = 0.0f;
      for (int t = 0; t < ps; ++t) acc = fmaf(p_s[g * ps + t], v_s[t * Dh + d], acc);
      o_s[i] = o_s[i] * c_s[g] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * Dh; i += nthr) {
    const int g = i / Dh, d = i % Dh;
    const size_t oi = ((size_t)b * Hq + h * G + g) * Dh + d;
    out[oi] = m_out != nullptr ? o_s[i] : o_s[i] / fmaxf(l_s[g], 1e-30f);
  }
  if (m_out != nullptr && tid < G) {
    m_out[(size_t)b * Hq + h * G + tid] = m_s[tid];
    l_out[(size_t)b * Hq + h * G + tid] = l_s[tid];
  }
}

template <typename KT>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* lengths, const int* window, const int* page_ok,
           float* out, float* m_out, float* l_out, int B, int M, int ps,
           int Hq, int Hkv, int Dh, int n, int es, float scale, float softcap,
           cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * (size_t)(2 * G * Dh + ps * (Dh + 1) +
                                               ps * Dh + G * ps + 3 * G) +
                      sizeof(int) * (size_t)(G * ps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B);
  paged_attention_kernel<KT><<<grid, 128, smem, s>>>(
      (const float*)q, (const KT*)k, (const KT*)v, bt, lengths, window,
      page_ok, out, m_out, l_out, M, ps, Hq, Hkv, Dh, n, es, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// kv_kind: 0 = int8 codes, 1 = int16 codes, 2 = float32, 3 = bfloat16.
// m_out / l_out non-null selects the unnormalized partials output.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* lengths, const void* window, const void* page_ok, void* out,
    void* m_out, void* l_out, int B, int M, int ps, int Hq, int Hkv, int Dh,
    int kv_kind, int n, int es, float scale, float softcap, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* bt_i = (const int*)bt;
  const int* len_i = (const int*)lengths;
  const int* win_i = (const int*)window;
  const int* ok_i = (const int*)page_ok;
  float* o = (float*)out;
  float* mo = (float*)m_out;
  float* lo = (float*)l_out;
  switch (kv_kind) {
    case 0:
      return launch<int8_t>(q, k_pages, v_pages, bt_i, len_i, win_i, ok_i, o,
                            mo, lo, B, M, ps, Hq, Hkv, Dh, n, es, scale,
                            softcap, s);
    case 1:
      return launch<int16_t>(q, k_pages, v_pages, bt_i, len_i, win_i, ok_i, o,
                             mo, lo, B, M, ps, Hq, Hkv, Dh, n, es, scale,
                             softcap, s);
    case 2:
      return launch<float>(q, k_pages, v_pages, bt_i, len_i, win_i, ok_i, o,
                           mo, lo, B, M, ps, Hq, Hkv, Dh, n, es, scale,
                           softcap, s);
    case 3:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, bt_i, len_i, win_i,
                                   ok_i, o, mo, lo, B, M, ps, Hq, Hkv, Dh, n,
                                   es, scale, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
