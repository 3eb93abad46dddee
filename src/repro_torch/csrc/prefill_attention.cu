// K5 prefill_attention: one prefill chunk of every slot in one launch --
// flash attention over [decoded history pages | raw chunk | pad], the posit
// encode of the chunk's K/V and their in-place page writes.
//
// Replaces src/repro/kernels/prefill_attention.py:prefill_attention_paged
// (_fused_prefill_kernel).  On the TPU the grid is (slot, page) and the
// page axis runs in order: each step stages one decoded page into a VMEM
// ring one flash chunk wide, folds a full ring into the running softmax,
// and merge-writes the page's chunk rows.  Blocks on Hopper run in no
// order, so here one block owns (slot b, KV head h, a tile of QT chunk
// queries) and serves the G = Hq / Hkv query heads of its group, R = G * QT
// rows, walking the slot's whole key span itself:
//   * keys: the span [history S_h = M * ps | chunk C | pad] is scanned in
//     flash chunks of ck = min(flash_chunk, S_h + C) keys -- the chunk
//     boundaries of models/common.py:flash_attention -- each staged kKT
//     keys at a time into shared memory.  History keys come from the
//     slot's pages through its block table, head h's Dh columns only,
//     decoded (posit.cuh) and rounded to the compute dtype as kv_decode
//     does; chunk keys are the raw (pre-encode) k / v.
//   * per flash chunk every score of the chunk is kept in shared memory
//     ([R][ck]); then m_new = max(m, row max), p = exp(s - m_new),
//     corr = exp(m - m_new), l = l * corr + sum p and o = o * corr + p @ v
//     (the o * corr term is kept, as the reference keeps it), and at the
//     end o / max(l, 1e-30).  Masked keys (history at or past the chunk
//     start, causal, window, pad) score -2e38 and get p = 0; tiles with no
//     live key are never loaded.
//   * page writes: each block encodes (RNE, as K2) the chunk rows of its
//     own query tile, head h's columns, and writes them in place.  Rows on
//     pages with bt = 0 or page_ok = 0 are not written.  History reads
//     cover rows < start and writes rows >= start, so within a slot they
//     are disjoint; across slots the serving engine forks every shared
//     page before the launch (copy-on-write), so no page is written by one
//     slot while another reads it.
//   * arithmetic is f32 FMA, not tensor cores: TF32 would round P(16,1)
//     history and the activations.
//
// Bound on an H100: at the serving shapes (4 slots, a 64-token chunk,
// 64 / 8 heads of 128, a span of 320 keys) the launch does about 2.7 GFLOP
// of f32 work over 3 MB of chunk activations and pages, so f32 SIMT rate,
// then latency, bounds it; a grid of B * Hkv * ceil(C / QT) blocks keeps
// the SMs busy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

constexpr float kNeg = -2.0e38f;
constexpr int kThreads = 256;
constexpr int kKT = 32;  // keys staged per tile

__device__ __forceinline__ float act_value(float x) { return x; }
__device__ __forceinline__ float act_value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void act_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void act_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float pool_value(int8_t c, int n, int es) {
  return posit_decode((uint32_t)(int)c, n, es);
}
__device__ __forceinline__ float pool_value(int16_t c, int n, int es) {
  return posit_decode((uint32_t)(int)c, n, es);
}
__device__ __forceinline__ float pool_value(float c, int, int) { return c; }
__device__ __forceinline__ float pool_value(__nv_bfloat16 c, int, int) {
  return __bfloat162float(c);
}

__device__ __forceinline__ void pool_store(int8_t* p, float x, int n, int es) {
  *p = (int8_t)posit_encode(x, n, es);
}
__device__ __forceinline__ void pool_store(int16_t* p, float x, int n, int es) {
  *p = (int16_t)posit_encode(x, n, es);
}
__device__ __forceinline__ void pool_store(float* p, float x, int, int) {
  *p = x;
}
__device__ __forceinline__ void pool_store(__nv_bfloat16* p, float x, int,
                                           int) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Does key tile [t0, t0 + nt) hold any key a query may attend: written
// history (position < start) or a chunk key?
__device__ __forceinline__ bool tile_live(int t0, int nt, int S_h, int C,
                                          int start) {
  return t0 < min(start, S_h) || (t0 + nt > S_h && t0 < S_h + C);
}

// Stage kKT keys (or values) of head h into kv_s [kKT][Dh + 1] as f32, and
// their positions into pos_s (-1 for unwritten history and pad).
template <typename AT, typename PT>
__device__ __forceinline__ void stage_tile(
    const PT* __restrict__ pool, const AT* __restrict__ raw,
    const int* __restrict__ bt_row, int b, int h, int t0, int nt, int S_h,
    int C, int start, int ps, int F, int Hkv, int Dh, int n, int es,
    int hist_bf16, float* kv_s, int* pos_s) {
  for (int i = threadIdx.x; i < kKT * Dh; i += kThreads) {
    const int t = i / Dh, d = i % Dh;
    const int kk = t0 + t;
    float val = 0.0f;
    int pos = -1;
    if (t < nt) {
      if (kk < S_h) {
        if (kk < start) {
          pos = kk;
          const size_t page = (size_t)bt_row[kk / ps];
          val = pool_value(pool[(page * ps + kk % ps) * F + (size_t)h * Dh + d],
                           n, es);
          if (hist_bf16) val = round_bf16(val);
        }
      } else if (kk < S_h + C) {
        const int j = kk - S_h;
        pos = start + j;
        val = act_value(raw[(((size_t)b * C + j) * Hkv + h) * Dh + d]);
      }
    }
    kv_s[t * (Dh + 1) + d] = val;
    if (d == 0) pos_s[t] = pos;
  }
}

template <typename AT, typename PT>
__global__ void __launch_bounds__(kThreads) prefill_attention_kernel(
    const AT* __restrict__ q, const AT* __restrict__ k,
    const AT* __restrict__ v, PT* __restrict__ k_pages,
    PT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ starts, const int* __restrict__ window,
    const int* __restrict__ page_ok, AT* __restrict__ out, int C, int M,
    int ps, int Hq, int Hkv, int Dh, int n, int es, int hist_bf16, int QT,
    int ck, float scale, float softcap) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int R = G * QT;
  const int F = Hkv * Dh;
  const int S_h = M * ps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = qt * QT;
  const int start = starts[b];
  const long long win = window[0];
  const int* bt_row = bt + (size_t)b * M;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [R][Dh], pre-scaled
  float* o_s = q_s + R * Dh;            // [R][Dh]
  float* pv_s = o_s + R * Dh;           // [R][Dh] this flash chunk's p @ v
  float* kv_s = pv_s + R * Dh;          // [kKT][Dh + 1] staged keys / values
  float* sc = kv_s + kKT * (Dh + 1);    // [R][ck] scores, then p
  float* m_s = sc + (size_t)R * ck;     // [R]
  float* l_s = m_s + R;                 // [R]
  float* c_s = l_s + R;                 // [R] corr of this flash chunk
  int* pos_s = reinterpret_cast<int*>(c_s + R);  // [kKT]

  // row r = qi * G + g: chunk query j0 + qi, query head h * G + g
  for (int i = tid; i < R * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh;
    const int j = j0 + r / G, g = r % G;
    float val = 0.0f;
    if (j < C) val = act_value(q[(((size_t)b * C + j) * Hq + h * G + g) * Dh + d]) * scale;
    q_s[i] = val;
    o_s[i] = 0.0f;
  }
  if (tid < R) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }

  // ---- encode + in-place page writes of this tile's chunk rows ----------
  const int j_end = min(j0 + QT, C);
  for (int i = tid; i < (j_end - j0) * Dh; i += kThreads) {
    const int j = j0 + i / Dh, d = i % Dh;
    const int pos = start + j;
    const int idx = min(max(pos / ps, 0), M - 1);
    const int page = bt_row[idx];
    if (page == 0) continue;
    if (page_ok != nullptr && page_ok[(size_t)b * M + idx] == 0) continue;
    const size_t src = (((size_t)b * C + j) * Hkv + h) * Dh + d;
    const size_t dst = ((size_t)page * ps + pos % ps) * F + (size_t)h * Dh + d;
    pool_store(k_pages + dst, act_value(k[src]), n, es);
    pool_store(v_pages + dst, act_value(v[src]), n, es);
  }

  // ---- running flash softmax over the key span --------------------------
  const int span = S_h + C;
  const int n_chunks = (span + ck - 1) / ck;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * ck;
    // sweep 1: every score of this flash chunk
    for (int t0 = base; t0 < base + ck; t0 += kKT) {
      const int nt = min(kKT, base + ck - t0);
      float* sc_t = sc + (t0 - base);
      if (!tile_live(t0, nt, S_h, C, start)) {
        for (int i = tid; i < R * kKT; i += kThreads) {
          const int r = i / kKT, t = i % kKT;
          if (t < nt) sc_t[(size_t)r * ck + t] = kNeg;
        }
        continue;
      }
      __syncthreads();  // the previous tile's readers are done with kv_s
      stage_tile(k_pages, k, bt_row, b, h, t0, nt, S_h, C, start, ps, F,
                 Hkv, Dh, n, es, hist_bf16, kv_s, pos_s);
      __syncthreads();
      for (int i = tid; i < R * kKT; i += kThreads) {
        const int r = i / kKT, t = i % kKT;
        if (t >= nt) continue;
        const int j = j0 + r / G;
        const int pos = pos_s[t];
        const int q_pos = start + j;
        float s = kNeg;
        if (j < C && pos >= 0 && q_pos >= pos &&
            (long long)(q_pos - pos) < win) {
          const float* qr = q_s + r * Dh;
          const float* kr = kv_s + t * (Dh + 1);
          float acc = 0.0f;
          for (int d = 0; d < Dh; ++d) acc = fmaf(qr[d], kr[d], acc);
          if (softcap > 0.0f) acc = softcap * tanhf(acc / softcap);
          s = acc;
        }
        sc_t[(size_t)r * ck + t] = s;
      }
    }
    __syncthreads();

    // row statistics: one warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      float* row = sc + (size_t)r * ck;
      float mx = kNeg;
      for (int t = lane; t < ck; t += 32) mx = fmaxf(mx, row[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int t = lane; t < ck; t += 32) {
        const float s = row[t];
        const float p = s == kNeg ? 0.0f : expf(s - m_new);
        row[t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }

    // sweep 2: p @ v of this flash chunk (each thread owns its pv_s / o_s
    // elements, so only the staging needs barriers)
    for (int i = tid; i < R * Dh; i += kThreads) pv_s[i] = 0.0f;
    for (int t0 = base; t0 < base + ck; t0 += kKT) {
      const int nt = min(kKT, base + ck - t0);
      if (!tile_live(t0, nt, S_h, C, start)) continue;
      __syncthreads();  // kv_s free, and p of every row written
      stage_tile(v_pages, v, bt_row, b, h, t0, nt, S_h, C, start, ps, F,
                 Hkv, Dh, n, es, hist_bf16, kv_s, pos_s);
      __syncthreads();
      for (int i = tid; i < R * Dh; i += kThreads) {
        const int r = i / Dh, d = i % Dh;
        const float* pr = sc + (size_t)r * ck + (t0 - base);
        float acc = pv_s[i];
        for (int t = 0; t < nt; ++t) acc = fmaf(pr[t], kv_s[t * (Dh + 1) + d], acc);
        pv_s[i] = acc;
      }
    }
    __syncthreads();  // c_s written; sc free for the next flash chunk
    for (int i = tid; i < R * Dh; i += kThreads) {
      o_s[i] = o_s[i] * c_s[i / Dh] + pv_s[i];
    }
  }
  __syncthreads();

  for (int i = tid; i < R * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh;
    const int j = j0 + r / G, g = r % G;
    if (j >= C) continue;
    act_store(out + (((size_t)b * C + j) * Hq + h * G + g) * Dh + d,
              o_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

size_t smem_bytes(int R, int Dh, int ck) {
  return sizeof(float) * ((size_t)3 * R * Dh + (size_t)kKT * (Dh + 1) +
                          (size_t)R * ck + 3 * (size_t)R) +
         sizeof(int) * kKT;
}

constexpr size_t kSmemCap = 200 * 1024;

template <typename AT, typename PT>
int launch(const void* q, const void* k, const void* v, void* k_pages,
           void* v_pages, const int* bt, const int* starts, const int* window,
           const int* page_ok, void* out, int B, int C, int M, int ps, int Hq,
           int Hkv, int Dh, int n, int es, int hist_bf16, int ck, float scale,
           float softcap, cudaStream_t s) {
  const int G = Hq / Hkv;
  int QT = 4;
  while (QT > 1 && smem_bytes(G * QT, Dh, ck) > kSmemCap) QT /= 2;
  const size_t smem = smem_bytes(G * QT, Dh, ck);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_attention_kernel<AT, PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((C + QT - 1) / QT, Hkv, B);
  prefill_attention_kernel<AT, PT><<<grid, kThreads, smem, s>>>(
      (const AT*)q, (const AT*)k, (const AT*)v, (PT*)k_pages, (PT*)v_pages,
      bt, starts, window, page_ok, (AT*)out, C, M, ps, Hq, Hkv, Dh, n, es,
      hist_bf16, QT, ck, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename AT>
int launch_pool(int pool_kind, const void* q, const void* k, const void* v,
                void* kp, void* vp, const int* bt, const int* st,
                const int* win, const int* ok, void* out, int B, int C, int M,
                int ps, int Hq, int Hkv, int Dh, int n, int es, int hist_bf16,
                int ck, float scale, float softcap, cudaStream_t s) {
  switch (pool_kind) {
    case 0:
      return launch<AT, int8_t>(q, k, v, kp, vp, bt, st, win, ok, out, B, C,
                                M, ps, Hq, Hkv, Dh, n, es, hist_bf16, ck,
                                scale, softcap, s);
    case 1:
      return launch<AT, int16_t>(q, k, v, kp, vp, bt, st, win, ok, out, B, C,
                                 M, ps, Hq, Hkv, Dh, n, es, hist_bf16, ck,
                                 scale, softcap, s);
    case 2:
      return launch<AT, float>(q, k, v, kp, vp, bt, st, win, ok, out, B, C,
                               M, ps, Hq, Hkv, Dh, n, es, hist_bf16, ck,
                               scale, softcap, s);
    case 3:
      return launch<AT, __nv_bfloat16>(q, k, v, kp, vp, bt, st, win, ok, out,
                                       B, C, M, ps, Hq, Hkv, Dh, n, es,
                                       hist_bf16, ck, scale, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// act_kind: 0 = float32, 1 = bfloat16 (q, k, v and the output).
// pool_kind: 0 = int8 codes, 1 = int16 codes, 2 = float32, 3 = bfloat16.
// hist_bf16: round decoded history to bf16 (the kv_decode dtype chain).
// page_ok may be null (every page writable).
extern "C" int prefill_attention_launch(
    const void* q, const void* k, const void* v, void* k_pages, void* v_pages,
    const void* bt, const void* starts, const void* window,
    const void* page_ok, void* out, int B, int C, int M, int ps, int Hq,
    int Hkv, int Dh, int act_kind, int pool_kind, int n, int es,
    int hist_bf16, int ck, float scale, float softcap, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* bt_i = (const int*)bt;
  const int* st_i = (const int*)starts;
  const int* win_i = (const int*)window;
  const int* ok_i = (const int*)page_ok;
  if (act_kind == 0) {
    return launch_pool<float>(pool_kind, q, k, v, k_pages, v_pages, bt_i,
                              st_i, win_i, ok_i, out, B, C, M, ps, Hq, Hkv,
                              Dh, n, es, hist_bf16, ck, scale, softcap, s);
  }
  if (act_kind == 1) {
    return launch_pool<__nv_bfloat16>(pool_kind, q, k, v, k_pages, v_pages,
                                      bt_i, st_i, win_i, ok_i, out, B, C, M,
                                      ps, Hq, Hkv, Dh, n, es, hist_bf16, ck,
                                      scale, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
