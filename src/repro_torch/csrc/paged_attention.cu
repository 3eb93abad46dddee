// K3 paged_attention and K7 paged_attention_mq: attention of new query
// tokens over block-table paged KV, with the posit decode of the pages
// done in the kernel.
//
// K3 replaces src/repro/kernels/paged_attention.py:paged_attention, 3-D q
// (_paged_attention_kernel): one decode token per slot.  K7 replaces
// _paged_attention_mq (_paged_attention_mq_kernel): T new tokens per slot,
// the speculative verify, where token i of slot b sits at position
// lengths[b] - T + i and attends causally over the history and the new
// tokens before it.  On the TPU the grid is (slot, [token tile,] page) and
// the page axis runs in order, carrying the running max / normalizer /
// output in VMEM scratch.  Blocks on Hopper run in no order, so here one
// block owns one (slot, KV head[, token tile]) and loops over the slot's
// pages itself:
//   * it stages the page's codes for its head into shared memory and
//     decodes them there (each code is read from HBM and decoded once per
//     block),
//   * it serves every query row of the group from that one decoded page:
//     the G = Hq / Hkv query heads (GQA reuse), times the t_block tokens of
//     its tile for K7,
//   * the running max m, normalizer l and output o of each row's streaming
//     softmax live in shared memory for the whole page loop,
//   * masking follows the TPU kernels (paged_attention.py:93-102, :168):
//     pos <= q_pos, q_pos - pos < window, page_ok[b, p] != 0.
//
// Both kernels run the same row body (attend_rows), so every row of K7 is
// bitwise the row K3 computes for one query at length q_pos + 1 over the
// same pages: a row visits exactly the pages K3 visits at that length (a
// page before the row's last, inside its window, with page_ok set) in
// ascending order, and every other page leaves it untouched, as K3's skip
// does; within a page the scores are fmaf over d in ascending order, the
// page max runs over unmasked positions only, then expf, corr =
// expf(m_old - m_new), l = fmaf(l, corr, sum p), o = fmaf(o, corr, sum p v)
// with sum p v an fmaf chain over the page's positions, and finally
// o / max(l, 1e-30).  Every multiply-add is written as an explicit fmaf so
// the compiler's contraction cannot differ between the two kernels.  Each
// value is computed by one thread, so the thread count does not change
// it, and neither does K7's t_block: rows are independent.  A slot of
// length 0 (or a row before position 0) yields finite zeros (m = -2e38,
// l = 0 with partials).
//
// Bound on an H100: at serving shapes (4 slots, 8 KV heads, Dh = 128,
// 16-token pages, a few hundred tokens, T = 4 for K7) a call moves about
// 2 MB, under a microsecond of HBM time, so launch latency and the serial
// page loop bound it, and a grid of B * Hkv blocks is enough.  Splitting
// long slots over several blocks (flash-decoding), tensor cores and TMA
// staging are left for when contexts grow.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

constexpr float kNeg = -2.0e38f;
constexpr int kThreadsK3 = 128;
constexpr int kThreadsK7 = 256;

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

// Shared memory of a block serving R query rows.
size_t smem_bytes(int R, int ps, int Dh) {
  return sizeof(float) * (size_t)(2 * R * Dh + ps * (Dh + 1) + ps * Dh +
                                  R * ps + 3 * R) +
         sizeof(int) * (size_t)(R * ps + 2 * R);
}

// The rows of one block: slot blockIdx.y, KV head blockIdx.x, tokens
// [t0, t0 + tb) of the slot's T new tokens.  Row r = tt * G + g is token
// t0 + tt with query head h * G + g; its query sits at position
// length - T + t0 + tt.  q / out are [B, T, Hq, Dh], m / l [B, T, Hq].
template <typename KT>
__device__ __forceinline__ void attend_rows(
    const float* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ lengths, const int* __restrict__ window,
    const int* __restrict__ page_ok, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int T, int t0,
    int tb, int M, int ps, int Hq, int Hkv, int Dh, int n, int es,
    float scale, float softcap) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int F = Hkv * Dh;
  const int R = tb * G;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [R][Dh], pre-scaled
  float* o_s = q_s + R * Dh;           // [R][Dh]
  float* k_s = o_s + R * Dh;           // [ps][Dh + 1] (padded rows)
  float* v_s = k_s + ps * (Dh + 1);    // [ps][Dh]
  float* p_s = v_s + ps * Dh;          // [R][ps] scores, then probabilities
  float* m_s = p_s + R * ps;           // [R]
  float* l_s = m_s + R;                // [R]
  float* c_s = l_s + R;                // [R] rescale factor of this page
  int* ok_s = reinterpret_cast<int*>(c_s + R);  // [R][ps] mask
  int* len_s = ok_s + R * ps;                   // [R] the row's length
  int* act_s = len_s + R;                       // [R] row visits this page

  const int length = lengths[b];
  const long long win = window[0];
  // the row of the [B * T * Hq] (query head) index space
  auto row_id = [&](int r) {
    return ((size_t)b * T + t0 + r / G) * Hq + (size_t)h * G + r % G;
  };
  // whether row r visits page p: exactly the pages K3's loop takes for
  // the row's length (before its last page, inside the window; page_ok is
  // checked for the whole block)
  auto visits = [&](int r, int p) {
    const int len = len_s[r];
    const int np = len > 0 ? min(M, (len + ps - 1) / ps) : 0;
    return p < np && (long long)p * ps + ps - 1 > (long long)len - 1 - win;
  };

  for (int i = tid; i < R * Dh; i += nthr) {
    const int r = i / Dh, d = i % Dh;
    q_s[i] = q[row_id(r) * Dh + d] * scale;
    o_s[i] = 0.0f;
  }
  if (tid < R) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
    len_s[tid] = length - T + t0 + tid / G + 1;  // its position + 1
  }
  const int last_len = length - T + t0 + tb;  // the block's longest row
  const int n_pages = last_len > 0 ? min(M, (last_len + ps - 1) / ps) : 0;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    // every thread takes the same decision: skip the page when no row of
    // the block visits it (the rows of one token share their length)
    if (page_ok != nullptr && page_ok[(size_t)b * M + p] == 0) continue;
    bool any = false;
    for (int r = G - 1; r < R; r += G) any = any || visits(r, p);
    if (!any) continue;
    if (tid < R) act_s[tid] = visits(tid, p);  // read after the barrier
    const size_t page = (size_t)bt[(size_t)b * M + p];
    const KT* kp = k_pages + page * ps * F + (size_t)h * Dh;
    const KT* vp = v_pages + page * ps * F + (size_t)h * Dh;
    for (int i = tid; i < ps * Dh; i += nthr) {
      const int t = i / Dh, d = i % Dh;
      k_s[t * (Dh + 1) + d] = kv_value(kp[(size_t)t * F + d], n, es);
      v_s[t * Dh + d] = kv_value(vp[(size_t)t * F + d], n, es);
    }
    __syncthreads();

    for (int i = tid; i < R * ps; i += nthr) {
      const int r = i / ps, t = i % ps;
      if (!act_s[r]) continue;
      float acc = 0.0f;
      for (int d = 0; d < Dh; ++d) {
        acc = fmaf(q_s[r * Dh + d], k_s[t * (Dh + 1) + d], acc);
      }
      if (softcap > 0.0f) acc = softcap * tanhf(acc / softcap);
      const long long len = len_s[r];
      const long long pos = (long long)p * ps + t;
      ok_s[i] = (pos < len) && (len - 1 - pos < win);
      p_s[i] = acc;
    }
    __syncthreads();

    if (tid < R && act_s[tid]) {
      const int r = tid;
      float mx = m_s[r];
      for (int t = 0; t < ps; ++t) {
        if (ok_s[r * ps + t]) mx = fmaxf(mx, p_s[r * ps + t]);
      }
      float lsum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float pr = ok_s[r * ps + t] ? expf(p_s[r * ps + t] - mx) : 0.0f;
        p_s[r * ps + t] = pr;
        lsum += pr;
      }
      const float corr = expf(m_s[r] - mx);
      c_s[r] = corr;
      l_s[r] = fmaf(l_s[r], corr, lsum);
      m_s[r] = mx;
    }
    __syncthreads();

    for (int i = tid; i < R * Dh; i += nthr) {
      const int r = i / Dh, d = i % Dh;
      if (!act_s[r]) continue;
      float acc = 0.0f;
      for (int t = 0; t < ps; ++t) {
        acc = fmaf(p_s[r * ps + t], v_s[t * Dh + d], acc);
      }
      o_s[i] = fmaf(o_s[i], c_s[r], acc);
    }
    __syncthreads();
  }

  for (int i = tid; i < R * Dh; i += nthr) {
    const int r = i / Dh, d = i % Dh;
    const size_t oi = row_id(r) * Dh + d;
    out[oi] = m_out != nullptr ? o_s[i] : o_s[i] / fmaxf(l_s[r], 1e-30f);
  }
  if (m_out != nullptr && tid < R) {
    m_out[row_id(tid)] = m_s[tid];
    l_out[row_id(tid)] = l_s[tid];
  }
}

// K3: one token per slot (T = 1), grid (Hkv, B).
template <typename KT>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ lengths, const int* __restrict__ window,
    const int* __restrict__ page_ok, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int M, int ps,
    int Hq, int Hkv, int Dh, int n, int es, float scale, float softcap) {
  attend_rows<KT>(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, 1, 0, 1, M, ps, Hq, Hkv, Dh, n, es, scale,
                  softcap);
}

// K7: T tokens per slot, grid (Hkv, B, T / tb); block z serves tokens
// [z * tb, (z + 1) * tb).
template <typename KT>
__global__ void paged_attention_mq_kernel(
    const float* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ lengths, const int* __restrict__ window,
    const int* __restrict__ page_ok, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int T, int tb,
    int M, int ps, int Hq, int Hkv, int Dh, int n, int es, float scale,
    float softcap) {
  attend_rows<KT>(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, T, blockIdx.z * tb, tb, M, ps, Hq, Hkv, Dh,
                  n, es, scale, softcap);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename KT>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* lengths, const int* window, const int* page_ok,
           float* out, float* m_out, float* l_out, int B, int M, int ps,
           int T, int tb, int Hq, int Hkv, int Dh, int n, int es, float scale,
           float softcap, bool mq, cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(tb * G, ps, Dh);
  if (mq) {
    cudaError_t e = allow_smem(paged_attention_mq_kernel<KT>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(Hkv, B, T / tb);
    paged_attention_mq_kernel<KT><<<grid, kThreadsK7, smem, s>>>(
        (const float*)q, (const KT*)k, (const KT*)v, bt, lengths, window,
        page_ok, out, m_out, l_out, T, tb, M, ps, Hq, Hkv, Dh, n, es, scale,
        softcap);
  } else {
    cudaError_t e = allow_smem(paged_attention_kernel<KT>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(Hkv, B);
    paged_attention_kernel<KT><<<grid, kThreadsK3, smem, s>>>(
        (const float*)q, (const KT*)k, (const KT*)v, bt, lengths, window,
        page_ok, out, m_out, l_out, M, ps, Hq, Hkv, Dh, n, es, scale,
        softcap);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* bt, const void* lengths, const void* window,
             const void* page_ok, void* out, void* m_out, void* l_out, int B,
             int M, int ps, int T, int tb, int Hq, int Hkv, int Dh,
             int kv_kind, int n, int es, float scale, float softcap, bool mq,
             void* stream) {
  if (T < 1 || tb < 1 || T % tb != 0 || Hkv < 1 || Hq % Hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // attend_rows gives each of a block's tb * G rows one thread for its
  // softmax state, so the rows may not outnumber the block's threads
  if (tb * (Hq / Hkv) > (mq ? kThreadsK7 : kThreadsK3)) {
    return (int)cudaErrorInvalidValue;
  }
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
                            mo, lo, B, M, ps, T, tb, Hq, Hkv, Dh, n, es,
                            scale, softcap, mq, s);
    case 1:
      return launch<int16_t>(q, k_pages, v_pages, bt_i, len_i, win_i, ok_i, o,
                             mo, lo, B, M, ps, T, tb, Hq, Hkv, Dh, n, es,
                             scale, softcap, mq, s);
    case 2:
      return launch<float>(q, k_pages, v_pages, bt_i, len_i, win_i, ok_i, o,
                           mo, lo, B, M, ps, T, tb, Hq, Hkv, Dh, n, es, scale,
                           softcap, mq, s);
    case 3:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, bt_i, len_i, win_i,
                                   ok_i, o, mo, lo, B, M, ps, T, tb, Hq, Hkv,
                                   Dh, n, es, scale, softcap, mq, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_kind: 0 = int8 codes, 1 = int16 codes, 2 = float32, 3 = bfloat16.
// m_out / l_out non-null selects the unnormalized partials output.
// K3: q / out [B, Hq, Dh], m / l [B, Hq].
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* lengths, const void* window, const void* page_ok, void* out,
    void* m_out, void* l_out, int B, int M, int ps, int Hq, int Hkv, int Dh,
    int kv_kind, int n, int es, float scale, float softcap, void* stream) {
  return dispatch(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, B, M, ps, 1, 1, Hq, Hkv, Dh, kv_kind, n, es,
                  scale, softcap, false, stream);
}

// K7: q / out [B, T, Hq, Dh], m / l [B, T, Hq]; t_block divides T.
extern "C" int paged_attention_mq_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* lengths, const void* window, const void* page_ok, void* out,
    void* m_out, void* l_out, int B, int M, int ps, int T, int t_block,
    int Hq, int Hkv, int Dh, int kv_kind, int n, int es, float scale,
    float softcap, void* stream) {
  return dispatch(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, B, M, ps, T, t_block, Hq, Hkv, Dh, kv_kind, n,
                  es, scale, softcap, true, stream);
}
