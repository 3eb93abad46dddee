// K5 prefill_attention: one prefill chunk of every slot in one call --
// flash attention over [decoded history pages | raw chunk | pad], the posit
// encode of the chunk's K/V and their in-place page writes.
//
// Replaces src/repro/kernels/prefill_attention.py:251
// prefill_attention_paged (its pl.pallas_call at :376,
// _fused_prefill_kernel).  On the TPU the grid is (slot, page) and the
// page axis runs in order: each step stages one decoded page into a VMEM
// ring one flash chunk wide, folds a full ring into the running softmax,
// and merge-writes the page's chunk rows.  The numerics to keep are
// models/common.py:flash_attention's: q * scale in f32, f32 scores,
// p = exp(s - m) in f32, v in f32 for p @ v, o * corr + p @ v, and
// o / max(l, 1e-30) at the end.
//
// Bound on an H100 at the serving shape (4 slots, a 64-token chunk, 64 / 8
// heads of 128, P(8,2) pages, spans of up to 320 keys): about 1.2 GFLOP of
// causal q.k and p.v work over some 3 MB of activations and codes: 1 us of
// HBM bytes, 1.2 us at the bf16 tensor-core rate (3.7 us for the three
// split terms below), 18 us at the f32 FMA rate.  So the arithmetic has
// to run on tensor cores, and at these sizes what is left is latency: few
// launches, enough blocks, no serial loops.
//
// The tensor-core variants take bf16 activations with a head_dim that is
// a multiple of 16: `tc` up to 128 (command-r, command-r-plus, qwen3,
// deepseek), `tc256` above 128 up to 256 (gemma3-4b).  Both start with
//   * prefill_attention_span_kernel, which decodes each history element once per
//     (slot, KV head) -- not once per query tile -- into a bf16 span buffer
//     [2 (K, V), B, Hkv, L, Dh] (L = history + chunk rounded up to 64
//     keys; unwritten history rows and pad are zeros), copies the raw chunk
//     k / v behind it, and encodes (RNE, as K2) the chunk rows into their
//     pages in place.  Rows on pages with bt = 0 or page_ok = 0 are not
//     written.  History reads cover rows < start and writes rows >= start,
//     so within a slot they are disjoint; across slots the serving engine
//     forks every shared page before the call (copy-on-write).  Hopper
//     blocks cannot wait for one another inside a launch, so one pass
//     over the span, which then sits in the 50 MB L2 for the next kernel,
//     is the simplest way to decode once and still keep 256 blocks busy.
//     Key tiles of 64 that no query of the slot may see (unwritten
//     history, pad, history before the window) are skipped: no attention
//     block loads them.
//   * prefill_attention_tc_kernel: one block per (64 query rows, KV head,
//     slot), 4 warps of 16 rows (row r = chunk query r / G, query head
//     h * G + r % G).  Key tiles of 64 stream from the span buffer through
//     shared memory with cp.async, double-buffered; tiles no row of the
//     block may see (past the causal edge, before the window, unwritten
//     history) are never loaded.  S = q K^T and O += P V run on
//     mma.sync.m16n8k16 bf16 with f32 accumulators, their K and V
//     fragments read by ldmatrix (.trans for V); the score accumulators
//     become P's A fragments in registers.
//   * exact products: every K and V operand is exact in bf16 (P(8,2) pages
//     have at most 3 fraction bits; other coded history is rounded to bf16
//     by the kv_decode dtype chain, hist_bf16; raw chunk k / v are bf16).
//     q * scale and p are f32: each is split exactly into three bf16 terms,
//     hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (x - hi is
//     exact and has at most 16 significant bits, x - hi - mid at most 8),
//     so x = hi + mid + lo and S = sum of three MMAs, P V likewise.  Every
//     product is exact; only the order of the f32 sums differs from the
//     plain version, as on the SIMT path.  (Below 2^-110, where lo or a
//     product would be an f32 subnormal, a term loses at most 2^-126, far
//     below the tolerance.)  No default path rounds q or p to one bf16 term.
//   * softmax: a running row max over the key tiles (m, l and the o * corr
//     rescale per tile) instead of one max per flash chunk: the same
//     function, with p = exp(s - m) rounded at other points; flash-chunk
//     boundaries therefore play no part here, and the shared-memory use is
//     70 KB per block at any span (2 blocks per SM).
//   * prefill_attention_tc256_kernel (head_dim up to 256): the same tiles,
//     mask, softmax and P V, with three changes that head_dim 256 forces.
//     O of 64 rows x 256 dims is 128 f32 registers a thread, so q stays in
//     shared memory and its A fragments are read by ldmatrix at every k
//     step.  q * scale is one bf16 term when the scale is a power of two
//     (1/16 at 256: q * scale is then exact in bf16), else three.  Q, K and
//     V take 99 KB at 256, so K and V are single-buffered and two blocks
//     share an SM: a tile's keys load during the previous tile's P V, its
//     values during its own S (double buffers, 165 KB and one block an
//     SM, took 1.35x as long on an H100 at gemma3's chunk shape,
//     scripts/time_k5.py).  gemma3's chunk group has only 2 x 4 x 4 = 32
//     blocks of 64 rows, so the key span is split: grid (split, 64-row
//     tile, KV head x slot),
//     split s covering key tiles [s TS, (s + 1) TS) (tc256_splits: TS 4,
//     more for spans past 32 splits; fixed by M, page size and C alone, so
//     a slot's rows never depend on another slot's start or the window).
//     A split writes its rows' (o, m, l) partials; a split that no row of
//     its block may see writes only (m, l) = (-2e38, 0) and loads nothing.
//     prefill_attention_merge_kernel combines a row's partials in split
//     order, skipping those with l = 0, and normalizes (one split: the
//     attention kernel writes the output itself).  Bound at gemma3's chunk
//     group (4 slots, C 64, 8 / 4 heads of 256, starts 1024-1960, window
//     1024): 4.3 GFLOP of exact bf16 products (one a q.k multiply-add,
//     three a p.v one), 4.3 us on the tensor cores, about 3 us of HBM
//     bytes.
// The tc_f32 variant (f32 activations, head_dim a multiple of 16 up to
// 256) runs the same tiles on tensor cores with every f32 operand split
// exactly into bf16 terms (below, before the launchers).
// The SIMT variant (head dims that are not a multiple of 16, or above 256)
// is prefill_attention_simt_kernel: one block per (slot, KV head, 4 chunk
// queries), every score of a flash chunk of ck keys in shared memory
// before its row max (the reference's per-flash-chunk softmax), f32 FMA
// throughout, and its own page writes of its query tile's rows.  Its key
// skip (tile_live) does not know the window: a slow spot for odd head
// dims only.  The wrapper picks the variant by dtype and head_dim
// (kernels/prefill_attention.py:prefill_variant).
//
// kv_pages-sharded pools (the reference's hist_pool_k / hist_pool_v /
// hist_bt, prefill_attention.py:129-130): every variant reads history
// through one pair of pool pointers and one block table, hist_k / hist_v
// / hbt, and writes the chunk's rows through k_pages / v_pages, bt and
// page_ok.  Unsharded they are the same pools and table.  Under a shard
// the caller passes the gathered global pool and the global ids for the
// reads, and the shard's own pool with the localized ids and their
// ownership mask for the writes.  A launch reads the same codes in the
// same order either way, so its attention output is bitwise the
// unsharded launch's over the same history bytes.  The reads cover rows
// < start and the writes rows >= start, so the two pointer pairs never
// touch one element from both sides when they alias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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
__global__ void __launch_bounds__(kThreads) prefill_attention_simt_kernel(
    const AT* __restrict__ q, const AT* __restrict__ k,
    const AT* __restrict__ v, PT* __restrict__ k_pages,
    PT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ starts, const int* __restrict__ window,
    const int* __restrict__ page_ok, const PT* __restrict__ hist_k,
    const PT* __restrict__ hist_v, const int* __restrict__ hbt,
    AT* __restrict__ out, int C, int M,
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
  const int* hbt_row = hbt + (size_t)b * M;

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
      stage_tile(hist_k, k, hbt_row, b, h, t0, nt, S_h, C, start, ps, F,
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
      stage_tile(hist_v, v, hbt_row, b, h, t0, nt, S_h, C, start, ps, F,
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename AT, typename PT>
int launch_simt(const void* q, const void* k, const void* v, void* k_pages,
           void* v_pages, const int* bt, const int* starts, const int* window,
           const int* page_ok, const void* hist_k, const void* hist_v,
           const int* hbt, void* out, int B, int C, int M, int ps, int Hq,
           int Hkv, int Dh, int n, int es, int hist_bf16, int ck, float scale,
           float softcap, cudaStream_t s) {
  const int G = Hq / Hkv;
  int QT = 4;
  while (QT > 1 && smem_bytes(G * QT, Dh, ck) > kSmemCap) QT /= 2;
  const size_t smem = smem_bytes(G * QT, Dh, ck);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(prefill_attention_simt_kernel<AT, PT>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + QT - 1) / QT, Hkv, B);
  prefill_attention_simt_kernel<AT, PT><<<grid, kThreads, smem, s>>>(
      (const AT*)q, (const AT*)k, (const AT*)v, (PT*)k_pages, (PT*)v_pages,
      bt, starts, window, page_ok, (const PT*)hist_k, (const PT*)hist_v, hbt,
      (AT*)out, C, M, ps, Hq, Hkv, Dh, n, es, hist_bf16, QT, ck, scale,
      softcap);
  return (int)cudaGetLastError();
}


// ---- tensor-core variant -------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps x 16 query rows
constexpr int kTcRows = 64;      // query rows per block
constexpr int kTcKeys = 64;      // keys per tile
constexpr int kDMax = 128;       // largest head_dim of this variant
constexpr int kPad = 8;          // bf16 pad per shared-memory row

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 -> three packed bf16 pairs with x = t[0] + t[1] + t[2] exactly
__device__ __forceinline__ void split3(float x0, float x1, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    t[i] = *reinterpret_cast<const uint32_t*>(&v);
    x0 -= __low2float(v);
    x1 -= __high2float(v);
  }
}

// not volatile: the compiler may interleave independent MMAs
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and r[i] receives matrix i's (row lane / 4,
// cols 2 (lane % 4), +1) -- with .trans its (rows 2 (lane % 4), +1, col
// lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Position of span key kk: history rows below start, chunk rows, else -1.
__device__ __forceinline__ int key_pos(int kk, int S_h, int C, int start) {
  if (kk < S_h) return kk < start ? kk : -1;
  return kk - S_h < C ? start + kk - S_h : -1;
}

// May any query position in [qlo, qhi] see a key of tile [t0, t0 + 64)?
// A key at position p is seen by queries in [p, p + win).
__device__ __forceinline__ bool tc_tile_live(int t0, int S_h, int C,
                                             int start, int qlo, int qhi,
                                             long long win) {
  const int t1 = t0 + kTcKeys;
  const int h1 = min(min(t1, S_h), start);
  if (t0 < h1 && t0 <= qhi && (long long)(h1 - 1) + win > qlo) return true;
  const int c0 = max(t0, S_h), c1 = min(t1, S_h + C);
  if (c0 >= c1) return false;
  const int p0 = start + c0 - S_h, p1 = start + c1 - 1 - S_h;
  return p0 <= qhi && (long long)p1 + win > qlo;
}

// A pool entry as f32: int8 codes from the decode table, others decoded.
template <typename PT>
__device__ __forceinline__ float table_or_decode(const float*, PT c, int n,
                                                 int es) {
  return pool_value(c, n, es);
}
__device__ __forceinline__ float table_or_decode(const float* table, int8_t c,
                                                 int, int) {
  return table[(uint8_t)c];
}

// Span rows of one (slot, KV head): the first half of the block's threads
// K, the second V, 128 / (Dh / 8) rows each, 8 values a thread.  int8
// pages decode through a 256-entry table in shared memory (one lookup a
// code).  Tiles that no query of the slot may see (tc_tile_live over the
// slot's positions [start, start + C)) are never loaded by the attention
// kernels, whose blocks see a subset of those positions, and are not
// written; in the others, unwritten history and pad rows are zeros.  Every
// chunk row's tile is live: a chunk row is copied and also encoded into
// its page (the page write).
template <typename PT>
__global__ void __launch_bounds__(256) prefill_attention_span_kernel(
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    PT* __restrict__ k_pages, PT* __restrict__ v_pages,
    const int* __restrict__ bt, const int* __restrict__ starts,
    const int* __restrict__ window, const int* __restrict__ page_ok,
    const PT* __restrict__ hist_k, const PT* __restrict__ hist_v,
    const int* __restrict__ hbt, bf16* __restrict__ span, int B, int C,
    int M, int ps, int Hkv, int Dh,
    int L, int n, int es) {
  constexpr bool kTable = std::is_same<PT, int8_t>::value;
  __shared__ float table[kTable ? 256 : 1];
  if (kTable) {
    table[threadIdx.x] = posit_decode(threadIdx.x, n, es);
    __syncthreads();
  }
  const int h = blockIdx.y, b = blockIdx.z;
  const int is_v = threadIdx.x >= 128, tid = threadIdx.x & 127;
  const int vecs = Dh / 8, rows = 128 / vecs;
  const int t = blockIdx.x * rows + tid / vecs;
  const int d0 = (tid % vecs) * 8;
  if (tid >= rows * vecs || t >= L) return;
  const int F = Hkv * Dh, S_h = M * ps, start = starts[b];
  if (!tc_tile_live(t / kTcKeys * kTcKeys, S_h, C, start, start,
                    start + C - 1, window[0]))
    return;
  PT* pages = is_v ? v_pages : k_pages;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (t < S_h) {
    if (t < start) {
      const PT* src = (is_v ? hist_v : hist_k) +
                      ((size_t)hbt[b * M + t / ps] * ps + t % ps) * F +
                      h * Dh + d0;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = table_or_decode(table, src[e], n, es);
      val = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                       pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    }
  } else if (t - S_h < C) {
    const int j = t - S_h;
    val = *reinterpret_cast<const uint4*>(
        (is_v ? v : k) + (((size_t)b * C + j) * Hkv + h) * Dh + d0);
    const int pos = start + j;
    const int idx = min(max(pos / ps, 0), M - 1);
    const int page = bt[b * M + idx];
    if (page != 0 && (page_ok == nullptr || page_ok[b * M + idx] != 0)) {
      PT* dst = pages + ((size_t)page * ps + pos % ps) * F + h * Dh + d0;
      const bf16* x8 = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        pool_store(dst + e, __bfloat162float(x8[e]), n, es);
    }
  }
  *reinterpret_cast<uint4*>(
      span + ((((size_t)is_v * B + b) * Hkv + h) * L + t) * Dh + d0) = val;
}

// Softcap, mask and the running max / sum over one 64-key tile at key t0:
// the scores s become p = exp(s - m), and o is rescaled by the tile's
// corr.  Element e of n-tile nt is row g + 8 * (e >> 1), key t0 + nt * 8 +
// tig * 2 + (e & 1); `whole` skips the mask.
template <int kNdn>
__device__ __forceinline__ void tile_softmax(
    float (&s)[kTcKeys / 8][4], float (&o)[kNdn][4], float* m_r, float* l_r,
    int t0, bool whole, const bool* rvalid, const int* qpos, int S_h, int C,
    int start, long long win, float softcap, int tig) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int nt = 0; nt < kTcKeys / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = s[nt][e];
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      if (!whole) {
        const int pos = key_pos(t0 + nt * 8 + tig * 2 + (e & 1), S_h, C,
                                start);
        const bool ok = rvalid[i] && pos >= 0 && qpos[i] >= pos &&
                        (long long)(qpos[i] - pos) < win;
        x = ok ? x : kNeg;
      }
      s[nt][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
  float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_r[i], mx[i]);
    corr[i] = expf(m_r[i] - m_new);
    m_r[i] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < kTcKeys / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = s[nt][e] == kNeg ? 0.0f : expf(s[nt][e] - m_r[i]);
      s[nt][e] = p;
      psum[i] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
    l_r[i] = l_r[i] * corr[i] + psum[i];
  }
#pragma unroll
  for (int dn = 0; dn < kNdn; ++dn) {
    o[dn][0] *= corr[0];
    o[dn][1] *= corr[0];
    o[dn][2] *= corr[1];
    o[dn][3] *= corr[1];
  }
}

// O += (hi + mid + lo)(P) V over one 64-key tile Vt [kTcKeys][DS], 16 keys
// per k step: the score fragments of n-tiles 2 kk and 2 kk + 1 are the A
// fragment of that step; dim tiles past ndn are left alone.
template <int kNdn>
__device__ __forceinline__ void tile_pv(float (&o)[kNdn][4],
                                        const float (&s)[kTcKeys / 8][4],
                                        const bf16* Vt, int DS, int ndn,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < kTcKeys / 16; ++kk) {
    uint32_t pa[3][4], t3[3];
    split3(s[2 * kk][0], s[2 * kk][1], t3);
#pragma unroll
    for (int i = 0; i < 3; ++i) pa[i][0] = t3[i];
    split3(s[2 * kk][2], s[2 * kk][3], t3);
#pragma unroll
    for (int i = 0; i < 3; ++i) pa[i][1] = t3[i];
    split3(s[2 * kk + 1][0], s[2 * kk + 1][1], t3);
#pragma unroll
    for (int i = 0; i < 3; ++i) pa[i][2] = t3[i];
    split3(s[2 * kk + 1][2], s[2 * kk + 1][3], t3);
#pragma unroll
    for (int i = 0; i < 3; ++i) pa[i][3] = t3[i];
    // B fragments of dim tiles dn and dn + 1 by one transposing
    // ldmatrix: lane l gives key kk * 16 + 8 * ((l / 8) % 2) + l % 8,
    // dims (dn + l / 16) * 8
    const bf16* vl = Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DS +
                     (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < kNdn; dn += 2) {
      if (dn >= ndn) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, vl + dn * 8);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        mma_bf16(o[dn], pa[i], b[0], b[1]);
        mma_bf16(o[dn + 1], pa[i], b[2], b[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 2) prefill_attention_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ span,
    const int* __restrict__ starts, const int* __restrict__ window,
    bf16* __restrict__ out, int B, int C, int M, int ps, int Hq, int Hkv,
    int Dh, int L, float scale, float softcap) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = G * C, S_h = M * ps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int start = starts[b];
  const long long win = window[0];
  const int DS = Dh + kPad;
  const int nks = Dh / 16, ndn = Dh / 8;

  extern __shared__ float4 tc_smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem4);  // [2][kTcKeys][DS]
  bf16* Vs = Ks + 2 * kTcKeys * DS;               // [2][kTcKeys][DS]
  const bf16* kspan = span + ((size_t)b * Hkv + h) * L * Dh;
  const bf16* vspan = span + (((size_t)B + b) * Hkv + h) * L * Dh;

  // this thread's rows: r_base + g and r_base + g + 8
  const int r_base = qt * kTcRows + warp * 16;
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_base + g + 8 * i;
    rvalid[i] = r < R;
    qpos[i] = start + r / G;
  }
  const int r_lo = qt * kTcRows, r_hi = min(R, r_lo + kTcRows) - 1;
  const int qlo = start + r_lo / G, qhi = start + r_hi / G;

  float o[kDMax / 8][4];
#pragma unroll
  for (int dn = 0; dn < kDMax / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};

  const int n_tiles = L / kTcKeys;
  auto next_live = [&](int t) {
    while (t < n_tiles &&
           !tc_tile_live(t * kTcKeys, S_h, C, start, qlo, qhi, win))
      ++t;
    return t;
  };
  auto issue = [&](int t, int buf) {
    const int per_row = Dh / 8;
    for (int c = threadIdx.x; c < kTcKeys * per_row; c += kTcThreads) {
      const int key = c / per_row, d8 = (c % per_row) * 8;
      const size_t src = (size_t)(t * kTcKeys + key) * Dh + d8;
      const int dst = (buf * kTcKeys + key) * DS + d8;
      cp_async16(Ks + dst, kspan + src);
      cp_async16(Vs + dst, vspan + src);
    }
    cp_async_commit();
  };

  // the block's 64 q rows, staged in the second K buffer (free until the
  // loop's first prefetch) together with the first key tile; rows past R
  // are zeros
  {
    const int per_row = Dh / 8;
    bf16* Qs = Ks + kTcKeys * DS;
    for (int c = threadIdx.x; c < kTcRows * per_row; c += kTcThreads) {
      const int row = c / per_row, d8 = (c % per_row) * 8;
      const int r = qt * kTcRows + row;
      if (r < R)
        cp_async16(Qs + row * DS + d8,
                   q + (((size_t)b * C + r / G) * Hq + h * G + r % G) * Dh +
                       d8);
      else
        *reinterpret_cast<uint4*>(Qs + row * DS + d8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
  int t = next_live(0), buf = 0;
  if (t < n_tiles) issue(t, 0);
  cp_async_wait_all();
  __syncthreads();

  // q * scale as three bf16 A fragments per 16-wide k step (ldmatrix:
  // lane l gives row l % 8 + 8 * ((l / 8) % 2), cols 8 * (l / 16))
  uint32_t qf[3][kDMax / 16][4];
  {
    const bf16* ql = Ks + kTcKeys * DS +
                     (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                     (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < kDMax / 16; ++ks) {
      if (ks >= nks) break;
      uint32_t raw[4];
      ldmatrix_x4(raw, ql + ks * 16);
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const __nv_bfloat162 x =
            *reinterpret_cast<const __nv_bfloat162*>(&raw[reg]);
        uint32_t t3[3];
        split3(__low2float(x) * scale, __high2float(x) * scale, t3);
#pragma unroll
        for (int i = 0; i < 3; ++i) qf[i][ks][reg] = t3[i];
      }
    }
  }

  while (t < n_tiles) {
    const int t_next = next_live(t + 1);
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
                      // (and, on the first pass, with the staged q rows)
    if (t_next < n_tiles) issue(t_next, buf ^ 1);
    const bf16* Kt = Ks + buf * kTcKeys * DS;
    const bf16* Vt = Vs + buf * kTcKeys * DS;

    // S = (hi + mid + lo) K^T over the tile's 64 keys (8 n-tiles of 8)
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    // B fragments of n-tiles 2 np and 2 np + 1 by one ldmatrix: lane l
    // gives key (2 np + l / 16) * 8 + l % 8, dims ks * 16 + 8 * ((l / 8) % 2);
    // a k step loads all 8 n-tiles, then runs the 3 terms across them
    const bf16* kl = Kt + ((lane >> 4) * 8 + (lane & 7)) * DS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kDMax / 16; ++ks) {
      if (ks >= nks) break;
      uint32_t b[kTcKeys / 16][4];
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np)
        ldmatrix_x4(b[np], kl + np * 16 * DS + ks * 16);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int np = 0; np < kTcKeys / 16; ++np) {
          mma_bf16(s[2 * np], qf[i][ks], b[np][0], b[np][1]);
          mma_bf16(s[2 * np + 1], qf[i][ks], b[np][2], b[np][3]);
        }
    }

    // A tile of written history that every row sees whole needs no mask
    // (rows past R are never stored, and their zero q gives finite scores).
    const bool whole = t * kTcKeys + kTcKeys <= min(start, S_h) &&
                       (long long)qhi - t * kTcKeys < win;
    tile_softmax(s, o, m_r, l_r, t * kTcKeys, whole, rvalid, qpos, S_h, C,
                 start, win, softcap, tig);
    tile_pv(o, s, Vt, DS, ndn, lane);
    t = t_next;
    buf ^= 1;
  }

  // o / max(l, 1e-30) -> bf16; element (dn, e) is row g + 8 * (e >> 1),
  // dims dn * 8 + tig * 2 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int r = r_base + g + 8 * i;
    bf16* dst =
        out + (((size_t)b * C + r / G) * Hq + h * G + r % G) * Dh + tig * 2;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < kDMax / 8; ++dn) {
      if (dn >= ndn) break;
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
          __floats2bfloat162_rn(o[dn][2 * i] / l, o[dn][2 * i + 1] / l);
    }
  }
}

// ---- tensor-core variant for head_dim up to 256 -------------------------

constexpr int kTc256DMax = 256;   // largest head_dim of tc256
constexpr int kSplitTiles = 4;    // key tiles a split covers, at least
constexpr int kMaxSplits = 32;    // beyond, a split covers more tiles
constexpr size_t kBlockSmem = 227 * 1024;  // what a block may take
// The launchers' return code for a head_dim the variant does not take
// (kernels/prefill_attention.py raises on it).
constexpr int kRefused = -1;

// The block's rows (as prefill_attention_tc_kernel's) over the live key
// tiles of split blockIdx.x, tiles [split TS, (split + 1) TS).  With S
// splits the rows' (o, m, l) go to part_o [rows, S, Dh] and part_ml
// [rows, S, 2] (a row with l = 0 writes (m, l) only); with one split the
// normalized output to out.  kQTerms: bf16 terms of q * scale (1 when
// scale is a power of two, so q * scale is exact in bf16; else 3).
template <int kQTerms>
__global__ void __launch_bounds__(kTcThreads, 2)
    prefill_attention_tc256_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ span,
        const int* __restrict__ starts, const int* __restrict__ window,
        bf16* __restrict__ out, float* __restrict__ part_o,
        float* __restrict__ part_ml, int B, int C, int M, int ps, int Hq,
        int Hkv, int Dh, int L, int TS, int S, float scale, float softcap) {
  const int split = blockIdx.x, qt = blockIdx.y;
  const int h = blockIdx.z % Hkv, b = blockIdx.z / Hkv;
  const int G = Hq / Hkv, R = G * C, S_h = M * ps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int start = starts[b];
  const long long win = window[0];
  const int DS = Dh + kPad;
  const int nks = Dh / 16, ndn = Dh / 8, per_row = Dh / 8;

  extern __shared__ float4 tc_smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem4);  // [kTcRows][DS]
  bf16* Ks = Qs + kTcRows * DS;                   // [kTcKeys][DS]
  bf16* Vs = Ks + kTcKeys * DS;                   // [kTcKeys][DS]
  const bf16* kspan = span + ((size_t)b * Hkv + h) * L * Dh;
  const bf16* vspan = span + (((size_t)B + b) * Hkv + h) * L * Dh;

  // this thread's rows: r_base + g and r_base + g + 8
  const int r_base = qt * kTcRows + warp * 16;
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_base + g + 8 * i;
    rvalid[i] = r < R;
    qpos[i] = start + r / G;
  }
  const int r_lo = qt * kTcRows, r_hi = min(R, r_lo + kTcRows) - 1;
  const int qlo = start + r_lo / G, qhi = start + r_hi / G;

  float o[kTc256DMax / 8][4];
#pragma unroll
  for (int dn = 0; dn < kTc256DMax / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};

  const int t_end = min(L / kTcKeys, (split + 1) * TS);
  auto next_live = [&](int t) {
    while (t < t_end &&
           !tc_tile_live(t * kTcKeys, S_h, C, start, qlo, qhi, win))
      ++t;
    return t;
  };
  // one tile of keys (or values) into dst, as its own commit group
  auto issue = [&](int t, bf16* dst_s, const bf16* src_g) {
    for (int c = threadIdx.x; c < kTcKeys * per_row; c += kTcThreads) {
      const int key = c / per_row, d8 = (c % per_row) * 8;
      cp_async16(dst_s + key * DS + d8,
                 src_g + (size_t)(t * kTcKeys + key) * Dh + d8);
    }
    cp_async_commit();
  };

  int t = next_live(split * TS);
  if (t < t_end) {
    // the block's 64 q rows (zeros past R), pre-scaled when one term is
    // exact; the loop's first barrier publishes them
    for (int c = threadIdx.x; c < kTcRows * per_row; c += kTcThreads) {
      const int row = c / per_row, d8 = (c % per_row) * 8;
      const int r = qt * kTcRows + row;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < R) {
        val = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * C + r / G) * Hq + h * G + r % G) * Dh + d8);
        if (kQTerms == 1) {
          __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x2[e] = __floats2bfloat162_rn(__low2float(x2[e]) * scale,
                                          __high2float(x2[e]) * scale);
        }
      }
      *reinterpret_cast<uint4*>(Qs + row * DS + d8) = val;
    }
    issue(t, Ks, kspan);
    issue(t, Vs, vspan);
  }
  // A fragments of q by ldmatrix: lane l gives row l % 8 + 8 * ((l / 8) %
  // 2), cols 8 * (l / 16) of the k step
  const bf16* ql = Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                   (lane >> 4) * 8;

  // K and V single-buffered (two blocks fit an SM): tile t + 1's keys
  // load during tile t's P V, its values during tile t + 1's S
  while (t < t_end) {
    const int t_next = next_live(t + 1);
    cp_async_wait_1();
    __syncthreads();  // keys of tile t landed (its values may not have)

    // S = q K^T over the tile's 64 keys (8 n-tiles of 8), B fragments as
    // in prefill_attention_tc_kernel
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    const bf16* kl = Ks + ((lane >> 4) * 8 + (lane & 7)) * DS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kTc256DMax / 16; ++ks) {
      if (ks >= nks) break;
      uint32_t a[4], bk[kTcKeys / 16][4];
      ldmatrix_x4(a, ql + ks * 16);
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np)
        ldmatrix_x4(bk[np], kl + np * 16 * DS + ks * 16);
      if constexpr (kQTerms == 1) {
#pragma unroll
        for (int np = 0; np < kTcKeys / 16; ++np) {
          mma_bf16(s[2 * np], a, bk[np][0], bk[np][1]);
          mma_bf16(s[2 * np + 1], a, bk[np][2], bk[np][3]);
        }
      } else {
        uint32_t qa[3][4];
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const __nv_bfloat162 x =
              *reinterpret_cast<const __nv_bfloat162*>(&a[reg]);
          uint32_t t3[3];
          split3(__low2float(x) * scale, __high2float(x) * scale, t3);
#pragma unroll
          for (int i = 0; i < 3; ++i) qa[i][reg] = t3[i];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int np = 0; np < kTcKeys / 16; ++np) {
            mma_bf16(s[2 * np], qa[i], bk[np][0], bk[np][1]);
            mma_bf16(s[2 * np + 1], qa[i], bk[np][2], bk[np][3]);
          }
      }
    }

    __syncthreads();  // every warp is done with the keys
    if (t_next < t_end) issue(t_next, Ks, kspan);
    const bool whole = t * kTcKeys + kTcKeys <= min(start, S_h) &&
                       (long long)qhi - t * kTcKeys < win;
    tile_softmax(s, o, m_r, l_r, t * kTcKeys, whole, rvalid, qpos, S_h, C,
                 start, win, softcap, tig);
    if (t_next < t_end)
      cp_async_wait_1();
    else
      cp_async_wait_all();
    __syncthreads();  // values of tile t landed
    tile_pv(o, s, Vs, DS, ndn, lane);
    __syncthreads();  // every warp is done with the values
    if (t_next < t_end) issue(t_next, Vs, vspan);
    t = t_next;
  }

  // element (dn, e) is row g + 8 * (e >> 1), dims dn * 8 + tig * 2 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int r = r_base + g + 8 * i;
    const size_t row = ((size_t)b * C + r / G) * Hq + h * G + r % G;
    if (S == 1) {
      bf16* dst = out + row * Dh + tig * 2;
      const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int dn = 0; dn < kTc256DMax / 8; ++dn) {
        if (dn >= ndn) break;
        *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
            __floats2bfloat162_rn(o[dn][2 * i] / l, o[dn][2 * i + 1] / l);
      }
      continue;
    }
    const size_t part = row * S + split;
    if (tig == 0) {
      part_ml[2 * part] = m_r[i];
      part_ml[2 * part + 1] = l_r[i];
    }
    if (l_r[i] == 0.0f) continue;  // the merge skips this partial
    float* dst = part_o + part * Dh + tig * 2;
#pragma unroll
    for (int dn = 0; dn < kTc256DMax / 8; ++dn) {
      if (dn >= ndn) break;
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
    }
  }
}

// A row's S partials combined in split order (those with l = 0 hold no
// key and are skipped), normalized to the output type (bf16 for tc256,
// f32 for tc_f32).  One thread per (row, dim).
template <typename OT>
__global__ void prefill_attention_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    OT* __restrict__ out, int rows, int S, int Dh) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * Dh) return;
  const size_t row = i / Dh;
  const float* ml = part_ml + row * S * 2;
  const float* po = part_o + row * S * Dh + i % Dh;
  float m = kNeg, l = 0.0f, o = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls == 0.0f) continue;
    const float ms = ml[2 * s], mn = fmaxf(m, ms);
    const float ca = expf(m - mn), cb = expf(ms - mn);
    l = fmaf(l, ca, ls * cb);
    o = fmaf(o, ca, po[(size_t)s * Dh] * cb);
    m = mn;
  }
  act_store(out + i, o / fmaxf(l, 1e-30f));
}

size_t tc_smem_bytes(int Dh) {
  return sizeof(bf16) * 4 * kTcKeys * (size_t)(Dh + kPad);
}

// Q, K and V of one tile (kernels/prefill_attention.py mirrors it).
size_t tc256_smem_bytes(int Dh) {
  return sizeof(bf16) * 3 * kTcKeys * (size_t)(Dh + kPad);
}

// Key tiles a tc256 split covers over n_tiles tiles (the wrapper's
// tc256_splits): shapes alone decide it.
int tc256_split_tiles(int n_tiles) {
  return max(kSplitTiles, (n_tiles + kMaxSplits - 1) / kMaxSplits);
}

template <typename PT>
cudaError_t launch_span(const void* k, const void* v, void* k_pages,
                        void* v_pages, const int* bt, const int* starts,
                        const int* window, const int* page_ok,
                        const void* hist_k, const void* hist_v,
                        const int* hbt, void* span, int B, int C, int M,
                        int ps, int Hkv, int Dh, int L, int n, int es,
                        cudaStream_t s) {
  const int rows = 128 / (Dh / 8);
  prefill_attention_span_kernel<PT>
      <<<dim3((L + rows - 1) / rows, Hkv, B), 256, 0, s>>>(
      (const bf16*)k, (const bf16*)v, (PT*)k_pages, (PT*)v_pages, bt, starts,
      window, page_ok, (const PT*)hist_k, (const PT*)hist_v, hbt,
      (bf16*)span, B, C, M, ps, Hkv, Dh, L, n, es);
  return cudaGetLastError();
}

template <typename PT>
int launch_tc(const void* q, const void* k, const void* v, void* k_pages,
              void* v_pages, const int* bt, const int* starts,
              const int* window, const int* page_ok, const void* hist_k,
              const void* hist_v, const int* hbt, void* out, void* span,
              int B, int C, int M, int ps, int Hq, int Hkv, int Dh, int n,
              int es, float scale, float softcap, cudaStream_t s) {
  if (Dh % 16 != 0 || Dh > kDMax) return (int)cudaErrorInvalidValue;
  const int L = (M * ps + C + kTcKeys - 1) / kTcKeys * kTcKeys;
  cudaError_t e = launch_span<PT>(k, v, k_pages, v_pages, bt, starts, window,
                                  page_ok, hist_k, hist_v, hbt, span, B, C, M,
                                  ps, Hkv, Dh, L, n, es, s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tc_smem_bytes(Dh);
  e = allow_smem(prefill_attention_tc_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int G = Hq / Hkv;
  dim3 grid((G * C + kTcRows - 1) / kTcRows, Hkv, B);
  prefill_attention_tc_kernel<<<grid, kTcThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)span, starts, window, (bf16*)out, B, C, M,
      ps, Hq, Hkv, Dh, L, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename PT>
int launch_tc256(const void* q, const void* k, const void* v, void* k_pages,
                 void* v_pages, const int* bt, const int* starts,
                 const int* window, const int* page_ok, const void* hist_k,
                 const void* hist_v, const int* hbt, void* out, void* span,
                 void* part_o, void* part_ml, int B, int C, int M, int ps,
                 int Hq, int Hkv, int Dh, int n, int es, int splits,
                 float scale, float softcap, cudaStream_t s) {
  const size_t smem = tc256_smem_bytes(Dh);
  if (Dh % 16 != 0 || Dh > kTc256DMax || smem > kBlockSmem) return kRefused;
  const int L = (M * ps + C + kTcKeys - 1) / kTcKeys * kTcKeys;
  const int n_tiles = L / kTcKeys, TS = tc256_split_tiles(n_tiles);
  const int S = (n_tiles + TS - 1) / TS;
  if (splits != S || (S > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_span<PT>(k, v, k_pages, v_pages, bt, starts, window,
                                  page_ok, hist_k, hist_v, hbt, span, B, C, M,
                                  ps, Hkv, Dh, L, n, es, s);
  if (e != cudaSuccess) return (int)e;
  int ex;
  auto kernel = std::frexp(scale, &ex) == 0.5f
                    ? prefill_attention_tc256_kernel<1>
                    : prefill_attention_tc256_kernel<3>;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int G = Hq / Hkv;
  dim3 grid(S, (G * C + kTcRows - 1) / kTcRows, Hkv * B);
  kernel<<<grid, kTcThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)span, starts, window, (bf16*)out,
      (float*)part_o, (float*)part_ml, B, C, M, ps, Hq, Hkv, Dh, L, TS, S,
      scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const int rows = B * C * Hq;
  const size_t total = (size_t)rows * Dh;
  prefill_attention_merge_kernel<bf16>
      <<<(unsigned)((total + 255) / 256), 256, 0, s>>>((const float*)part_o,
                                        (const float*)part_ml, (bf16*)out,
                                        rows, S, Dh);
  return (int)cudaGetLastError();
}

// ---- tensor-core variant for f32 activations (tc_f32) --------------------
//
// f32 q / k / v exactly on bf16 tensor cores.  Every f32 x is three bf16
// terms, x = hi + mid + lo exactly (split3), and every product of two
// terms is exact in f32, so S = sum over term pairs and P V likewise give
// the exact products, summed in another order than the plain version.
// How many terms a key or value needs depends on where it comes from:
//   * the chunk's own rows are raw f32: three terms;
//   * history decodes from its pages: one term when the decoded value is
//     rounded to bf16 (hist_bf16, the kv_decode dtype chain) or the pool
//     holds bf16, or the code's significand has at most 8 bits (P(8,x),
//     P(10,2)); two up to 16 bits (P(13,x), P(16,x)); an f32 pool three
//     (prefill_hist_terms, mirrored by kernels/prefill_attention.py).
// A key tile takes three terms when it holds a chunk row, else the
// history's count (the tile is the unit of work; the bound counts keys).
//   * prefill_attention_span_f32_kernel decodes, splits and writes the
//     span once per (slot, KV head): [2 (K, V)][3 terms][B][Hkv][L][Dh]
//     bf16, only the planes a tile takes; and encodes the chunk rows into
//     their pages from the f32 values (the same page writes as SIMT).
//   * prefill_attention_tcf32_kernel<kD>: the tc / tc256 block (64
//     query rows of one KV head, 4 warps of 16 rows, mma.sync m16n8k16)
//     with the span streamed as units, one unit a (tile, K or V, term
//     plane), through a ring of kRing unit buffers by cp.async, kRing - 1
//     units ahead: a tile of one-term history costs what it costs tc (a K
//     and a V unit, three MMAs a fragment each), the chunk's tile three
//     of each.  A tile's K planes come lo first and hi last, and the hi
//     plane's products of hi q run after its others: the f32 accumulator
//     holds the small terms' sum (about 2^-8 of the score) until the 8 k
//     steps of the largest products, so few of its steps round at the
//     score's own magnitude.  q * scale is split into three terms: held in
//     registers as A fragments up to head_dim 128 (kD 128: 4 units in
//     the ring, 70 KB, two blocks an SM), above it kept as f32 in shared
//     memory and split at every k step (kD 256: 68 KB of q and 3 units,
//     169 KB, one block an SM), the key span split across blocks and the
//     partials merged as tc256 does (same splits).
// Bound at the serving shape (B 4, C 64, 64 / 8 heads x 128, P(8,2)
// pages, spans of up to 320 keys): the exact form's products, three a q.k
// multiply-add of history and nine of the chunk (and as many for p.v), at
// the bf16 tensor-core rate (kernels/work.py:prefill, variant tc_f32).

// bf16 terms of decoded history: the kv_decode chain's bf16 rounding and
// bf16 pools give one, an f32 pool three, posit codes by their widest
// significand (n - 2 - es bits, the hidden bit included)
int prefill_hist_terms(int pool_kind, int n, int es, int hist_bf16) {
  if (hist_bf16 || pool_kind == 3) return 1;
  if (pool_kind == 2) return 3;
  const int bits = n - 2 - es;
  return bits <= 8 ? 1 : bits <= 16 ? 2 : 3;
}

// Terms of key tile `tile`: three when it holds a chunk row (at S_h and
// above), else the history's.
__device__ __forceinline__ int tcf32_tile_terms(int tile, int S_h,
                                                int hist_terms) {
  return (tile + 1) * kTcKeys > S_h ? 3 : hist_terms;
}

// The f32 span: as prefill_attention_span_kernel (the same rows, tiles
// and page writes), each value split into the planes its tile takes.
template <typename PT>
__global__ void __launch_bounds__(256) prefill_attention_span_f32_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    PT* __restrict__ k_pages, PT* __restrict__ v_pages,
    const int* __restrict__ bt, const int* __restrict__ starts,
    const int* __restrict__ window, const int* __restrict__ page_ok,
    const PT* __restrict__ hist_k, const PT* __restrict__ hist_v,
    const int* __restrict__ hbt, bf16* __restrict__ span, int B, int C,
    int M, int ps, int Hkv, int Dh, int L, int n, int es, int hist_bf16,
    int hist_terms) {
  constexpr bool kTable = std::is_same<PT, int8_t>::value;
  __shared__ float table[kTable ? 256 : 1];
  if (kTable) {
    table[threadIdx.x] = posit_decode(threadIdx.x, n, es);
    __syncthreads();
  }
  const int h = blockIdx.y, b = blockIdx.z;
  const int is_v = threadIdx.x >= 128, tid = threadIdx.x & 127;
  const int vecs = Dh / 8, rows = 128 / vecs;
  const int t = blockIdx.x * rows + tid / vecs;
  const int d0 = (tid % vecs) * 8;
  if (tid >= rows * vecs || t >= L) return;
  const int F = Hkv * Dh, S_h = M * ps, start = starts[b];
  if (!tc_tile_live(t / kTcKeys * kTcKeys, S_h, C, start, start,
                    start + C - 1, window[0]))
    return;
  PT* pages = is_v ? v_pages : k_pages;
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = 0.0f;
  if (t < S_h) {
    if (t < start) {
      const PT* src = (is_v ? hist_v : hist_k) +
                      ((size_t)hbt[b * M + t / ps] * ps + t % ps) * F +
                      h * Dh + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = table_or_decode(table, src[e], n, es);
        if (hist_bf16) x[e] = round_bf16(x[e]);
      }
    }
  } else if (t - S_h < C) {
    const int j = t - S_h;
    const float4* src = reinterpret_cast<const float4*>(
        (is_v ? v : k) + (((size_t)b * C + j) * Hkv + h) * Dh + d0);
    const float4 lo = src[0], hi = src[1];
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
    const int pos = start + j;
    const int idx = min(max(pos / ps, 0), M - 1);
    const int page = bt[b * M + idx];
    if (page != 0 && (page_ok == nullptr || page_ok[b * M + idx] != 0)) {
      PT* dst = pages + ((size_t)page * ps + pos % ps) * F + h * Dh + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) pool_store(dst + e, x[e], n, es);
    }
  }
  const int terms = tcf32_tile_terms(t / kTcKeys, S_h, hist_terms);
  const size_t plane = (size_t)B * Hkv * L * Dh;
  bf16* dst = span + (size_t)is_v * 3 * plane +
              (((size_t)b * Hkv + h) * L + t) * Dh + d0;
  for (int i = 0; i < terms; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&p2);
      x[2 * e] -= __low2float(p2);
      x[2 * e + 1] -= __high2float(p2);
    }
    *reinterpret_cast<uint4*>(dst + i * plane) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// S += (q term i) K^T over one unit (64 keys of one K term plane) for
// the terms i in [I0, I1), the highest first; B fragments as in
// prefill_attention_tc_kernel.  QA(ks, a) writes q's three A fragments of
// k step ks into a.
template <int kD, int I0, int I1, typename QA>
__device__ __forceinline__ void tcf32_scores(float (&s)[kTcKeys / 8][4],
                                             const bf16* U, int DS, int nks,
                                             int lane, QA qa) {
  const bf16* kl =
      U + ((lane >> 4) * 8 + (lane & 7)) * DS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    if (ks >= nks) break;
    uint32_t bk[kTcKeys / 16][4], a[3][4];
#pragma unroll
    for (int np = 0; np < kTcKeys / 16; ++np)
      ldmatrix_x4(bk[np], kl + np * 16 * DS + ks * 16);
    qa(ks, a);
#pragma unroll
    for (int i = I1 - 1; i >= I0; --i)
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        mma_bf16(s[2 * np], a[i], bk[np][0], bk[np][1]);
        mma_bf16(s[2 * np + 1], a[i], bk[np][2], bk[np][3]);
      }
  }
}

// The block's rows (as prefill_attention_tc_kernel's) over the live key
// tiles of split blockIdx.x, tiles [split TS, (split + 1) TS), from the
// f32 span's term planes; with S splits the rows' (o, m, l) go to part_o
// [rows, S, Dh] and part_ml [rows, S, 2], with one the normalized f32
// output to out.
template <int kD>
__global__ void __launch_bounds__(kTcThreads, kD <= kDMax ? 2 : 1)
    prefill_attention_tcf32_kernel(
        const float* __restrict__ q, const bf16* __restrict__ span,
        const int* __restrict__ starts, const int* __restrict__ window,
        float* __restrict__ out, float* __restrict__ part_o,
        float* __restrict__ part_ml, int B, int C, int M, int ps, int Hq,
        int Hkv, int Dh, int L, int TS, int S, int hist_terms, float scale,
        float softcap) {
  constexpr bool kQRegs = kD <= kDMax;
  constexpr int kRing = kQRegs ? 4 : 3;
  const int split = blockIdx.x, qt = blockIdx.y;
  const int h = blockIdx.z % Hkv, b = blockIdx.z / Hkv;
  const int G = Hq / Hkv, R = G * C, S_h = M * ps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int start = starts[b];
  const long long win = window[0];
  const int DS = Dh + kPad, QS = Dh + 8;
  const int nks = Dh / 16, ndn = Dh / 8, per_row = Dh / 8;

  extern __shared__ float4 tc_smem4[];
  float* Qf = reinterpret_cast<float*>(tc_smem4);  // [kTcRows][QS] (smem q)
  bf16* ring = reinterpret_cast<bf16*>(kQRegs ? Qf : Qf + kTcRows * QS);
  const size_t plane = (size_t)B * Hkv * L * Dh;
  const bf16* kv0 = span + ((size_t)b * Hkv + h) * L * Dh;

  // this thread's rows: r_base + g and r_base + g + 8
  const int r_base = qt * kTcRows + warp * 16;
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_base + g + 8 * i;
    rvalid[i] = r < R;
    qpos[i] = start + r / G;
  }
  const int r_lo = qt * kTcRows, r_hi = min(R, r_lo + kTcRows) - 1;
  const int qlo = start + r_lo / G, qhi = start + r_hi / G;

  float o[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};

  const int t_end = min(L / kTcKeys, (split + 1) * TS);
  auto next_live = [&](int t) {
    while (t < t_end &&
           !tc_tile_live(t * kTcKeys, S_h, C, start, qlo, qhi, win))
      ++t;
    return t;
  };
  // the unit stream: per live tile, its K planes lo to hi, then its V
  // planes lo to hi; (it, iu) the next unit to issue
  int it = next_live(split * TS), iu = 0;
  int iT = it < t_end ? tcf32_tile_terms(it, S_h, hist_terms) : 0;
  int issued = 0;
  auto issue = [&]() {
    if (it < t_end) {
      const int kv = iu < iT ? 0 : 1;
      const int term = kv == 0 ? iT - 1 - iu : 2 * iT - 1 - iu;
      const bf16* src = kv0 + (size_t)(kv * 3 + term) * plane +
                        (size_t)it * kTcKeys * Dh;
      bf16* dst = ring + (size_t)(issued % kRing) * kTcKeys * DS;
      for (int c = threadIdx.x; c < kTcKeys * per_row; c += kTcThreads) {
        const int key = c / per_row, d8 = (c % per_row) * 8;
        cp_async16(dst + key * DS + d8, src + (size_t)key * Dh + d8);
      }
      if (++iu == 2 * iT) {
        it = next_live(it + 1);
        iu = 0;
        iT = it < t_end ? tcf32_tile_terms(it, S_h, hist_terms) : 0;
      }
    }
    cp_async_commit();  // empty past the last unit: completes at once
    ++issued;
  };

  // q * scale: A fragments in registers (three terms), or f32 rows in
  // shared memory that the loop's first barrier publishes
  uint32_t qf[kQRegs ? 3 : 1][kQRegs ? kD / 16 : 1][4];
  auto q_row = [&](int r) {
    return q + (((size_t)b * C + r / G) * Hq + h * G + r % G) * Dh;
  };
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      if (ks >= nks) break;
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        // a[reg]: row g + 8 (reg & 1), cols ks 16 + 2 tig + 8 (reg >> 1)
        const int r = r_base + g + 8 * (reg & 1);
        float2 x = make_float2(0.0f, 0.0f);
        if (r < R)
          x = *reinterpret_cast<const float2*>(q_row(r) + ks * 16 + 2 * tig +
                                               8 * (reg >> 1));
        uint32_t t3[3];
        split3(x.x * scale, x.y * scale, t3);
#pragma unroll
        for (int i = 0; i < 3; ++i) qf[i][ks][reg] = t3[i];
      }
    }
  } else {
    if (it < t_end) {
      for (int c = threadIdx.x; c < kTcRows * (Dh / 4); c += kTcThreads) {
        const int row = c / (Dh / 4), d4 = (c % (Dh / 4)) * 4;
        const int r = qt * kTcRows + row;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < R) x = *reinterpret_cast<const float4*>(q_row(r) + d4);
        *reinterpret_cast<float4*>(Qf + row * QS + d4) =
            make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      }
    }
  }
  const float* qs_l = Qf + (warp * 16 + g) * QS + 2 * tig;
  auto qa = [&](int ks, uint32_t (&a)[3][4]) {
    if constexpr (kQRegs) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) a[i][reg] = qf[i][ks][reg];
    } else {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const float2 x = *reinterpret_cast<const float2*>(
            qs_l + 8 * (reg & 1) * QS + ks * 16 + 8 * (reg >> 1));
        uint32_t t3[3];
        split3(x.x, x.y, t3);
#pragma unroll
        for (int i = 0; i < 3; ++i) a[i][reg] = t3[i];
      }
    }
  };

#pragma unroll 1
  for (int u = 0; u < kRing - 1; ++u) issue();
  int n = 0;  // units consumed
#pragma unroll 1
  for (int t = next_live(split * TS); t < t_end; t = next_live(t + 1)) {
    const int T = tcf32_tile_terms(t, S_h, hist_terms);
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll 1
    for (int u = 0; u < 2 * T; ++u, ++n) {
      cp_async_wait_n<kRing - 2>();
      __syncthreads();  // unit n landed; every warp is done with unit n - 1
      issue();          // into unit n - 1's buffer
      const bf16* U = ring + (size_t)(n % kRing) * kTcKeys * DS;
      if (u < T) {
        if (u < T - 1) {  // a lower plane: every q term
          tcf32_scores<kD, 0, 3>(s, U, DS, nks, lane, qa);
        } else {  // the hi plane: q's lower terms, then its hi term
          tcf32_scores<kD, 1, 3>(s, U, DS, nks, lane, qa);
          tcf32_scores<kD, 0, 1>(s, U, DS, nks, lane, qa);
          const bool whole = t * kTcKeys + kTcKeys <= min(start, S_h) &&
                             (long long)qhi - t * kTcKeys < win;
          tile_softmax(s, o, m_r, l_r, t * kTcKeys, whole, rvalid, qpos,
                       S_h, C, start, win, softcap, tig);
        }
      } else {
        tile_pv(o, s, U, DS, ndn, lane);
      }
    }
  }
  cp_async_wait_n<0>();

  // element (dn, e) is row g + 8 * (e >> 1), dims dn * 8 + tig * 2 + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int r = r_base + g + 8 * i;
    const size_t row = ((size_t)b * C + r / G) * Hq + h * G + r % G;
    if (S == 1) {
      float* dst = out + row * Dh + tig * 2;
      const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        if (dn >= ndn) break;
        *reinterpret_cast<float2*>(dst + dn * 8) =
            make_float2(o[dn][2 * i] / l, o[dn][2 * i + 1] / l);
      }
      continue;
    }
    const size_t part = row * S + split;
    if (tig == 0) {
      part_ml[2 * part] = m_r[i];
      part_ml[2 * part + 1] = l_r[i];
    }
    if (l_r[i] == 0.0f) continue;  // the merge skips this partial
    float* dst = part_o + part * Dh + tig * 2;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      if (dn >= ndn) break;
      *reinterpret_cast<float2*>(dst + dn * 8) =
          make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
    }
  }
}

// Shared memory of a tc_f32 block (kernels/prefill_attention.py mirrors
// it): kRing bf16 units of 64 keys, and above head_dim 128 the block's 64
// q rows in f32.
size_t tcf32_smem_bytes(int Dh) {
  const size_t unit = sizeof(bf16) * kTcKeys * (size_t)(Dh + kPad);
  return Dh <= kDMax ? 4 * unit
                     : 3 * unit + sizeof(float) * kTcRows * (size_t)(Dh + 8);
}

template <typename PT>
int launch_tcf32(const void* q, const void* k, const void* v, void* k_pages,
                 void* v_pages, const int* bt, const int* starts,
                 const int* window, const int* page_ok, const void* hist_k,
                 const void* hist_v, const int* hbt, void* out, void* span,
                 void* part_o, void* part_ml, int B, int C, int M, int ps,
                 int Hq, int Hkv, int Dh, int n, int es, int hist_bf16,
                 int pool_kind, int splits, float scale, float softcap,
                 cudaStream_t s) {
  const size_t smem = tcf32_smem_bytes(Dh);
  if (Dh % 16 != 0 || Dh <= 0 || Dh > kTc256DMax || smem > kBlockSmem)
    return kRefused;
  const int L = (M * ps + C + kTcKeys - 1) / kTcKeys * kTcKeys;
  const int n_tiles = L / kTcKeys;
  const int TS = Dh <= kDMax ? n_tiles : tc256_split_tiles(n_tiles);
  const int S = (n_tiles + TS - 1) / TS;
  if (splits != S || (S > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int hist_terms = prefill_hist_terms(pool_kind, n, es, hist_bf16);
  const int rows = 128 / (Dh / 8);
  prefill_attention_span_f32_kernel<PT>
      <<<dim3((L + rows - 1) / rows, Hkv, B), 256, 0, s>>>(
      (const float*)k, (const float*)v, (PT*)k_pages, (PT*)v_pages, bt,
      starts, window, page_ok, (const PT*)hist_k, (const PT*)hist_v, hbt,
      (bf16*)span, B, C, M, ps, Hkv, Dh, L, n, es, hist_bf16, hist_terms);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = Dh <= kDMax ? prefill_attention_tcf32_kernel<kDMax>
                            : prefill_attention_tcf32_kernel<kTc256DMax>;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int G = Hq / Hkv;
  dim3 grid(S, (G * C + kTcRows - 1) / kTcRows, Hkv * B);
  kernel<<<grid, kTcThreads, smem, s>>>(
      (const float*)q, (const bf16*)span, starts, window, (float*)out,
      (float*)part_o, (float*)part_ml, B, C, M, ps, Hq, Hkv, Dh, L, TS, S,
      hist_terms, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const size_t total = (size_t)B * C * Hq * Dh;
  prefill_attention_merge_kernel<float>
      <<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          (const float*)part_o, (const float*)part_ml, (float*)out,
          B * C * Hq, S, Dh);
  return (int)cudaGetLastError();
}

template <typename AT>
int launch_pool(int variant, int pool_kind, const void* q, const void* k,
                const void* v, void* kp, void* vp, const int* bt,
                const int* st, const int* win, const int* ok,
                const void* hk, const void* hv, const int* hbt, void* out,
                void* span, void* part_o, void* part_ml, int B, int C, int M,
                int ps, int Hq, int Hkv, int Dh, int n, int es, int hist_bf16,
                int ck, int splits, float scale, float softcap,
                cudaStream_t s) {
  constexpr bool kBf16 = std::is_same<AT, __nv_bfloat16>::value;
#define K5_LAUNCH(PT)                                                        \
  if (variant == 1)                                                          \
    return kBf16 ? launch_tc<PT>(q, k, v, kp, vp, bt, st, win, ok, hk, hv,  \
                                 hbt, out, span, B, C, M, ps, Hq, Hkv, Dh,   \
                                 n, es, scale, softcap, s)                   \
                 : (int)cudaErrorInvalidValue;                               \
  if (variant == 2)                                                          \
    return kBf16 ? launch_tc256<PT>(q, k, v, kp, vp, bt, st, win, ok, hk,   \
                                    hv, hbt, out, span, part_o, part_ml, B,  \
                                    C, M, ps, Hq,                            \
                                    Hkv, Dh, n, es, splits, scale, softcap,  \
                                    s)                                       \
                 : (int)cudaErrorInvalidValue;                               \
  if (variant == 3)                                                          \
    return kBf16 ? (int)cudaErrorInvalidValue                                \
                 : launch_tcf32<PT>(q, k, v, kp, vp, bt, st, win, ok, hk,   \
                                    hv, hbt, out, span, part_o, part_ml, B,  \
                                    C, M, ps, Hq, Hkv, Dh, n, es, hist_bf16, \
                                    pool_kind, splits, scale, softcap, s);   \
  return launch_simt<AT, PT>(q, k, v, kp, vp, bt, st, win, ok, hk, hv, hbt,  \
                             out, B, C, M, ps, Hq, Hkv, Dh, n, es,           \
                             hist_bf16, ck, scale, softcap, s)
  switch (pool_kind) {
    case 0:
      K5_LAUNCH(int8_t);
    case 1:
      K5_LAUNCH(int16_t);
    case 2:
      K5_LAUNCH(float);
    case 3:
      K5_LAUNCH(__nv_bfloat16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K5_LAUNCH
}

}  // namespace

// act_kind: 0 = float32, 1 = bfloat16 (q, k, v and the output).
// pool_kind: 0 = int8 codes, 1 = int16 codes, 2 = float32, 3 = bfloat16.
// variant (the wrapper's prefill_variant): 0 = SIMT, 1 = tensor cores up
// to head_dim 128, 2 = tensor cores up to 256 with the key span split
// (both bf16 activations and Dh a multiple of 16; `span` is their bf16
// [2, B, Hkv, L, Dh] scratch, L = M * ps + C rounded up to 64; variant 2
// takes `splits` = tc256_splits and, with more than one, its f32
// partials part_o [B * C * Hq, splits, Dh] and part_ml [.., splits, 2]),
// 3 = tensor cores for f32 activations with Dh a multiple of 16 up to 256
// (`span` its bf16 term planes [2, 3, B, Hkv, L, Dh]; above 128 the key
// span split as variant 2's, `splits` and the partials likewise).
// hist_bf16: round decoded history to bf16 (the kv_decode dtype chain;
// always so on the tensor-core variants).  page_ok may be null (every page
// writable).  hist_k / hist_v / hist_bt (all three or none): the pools and
// the [B, M] block tables history is read from (a sharded pool's gathered
// global pool and global ids); null reads history from k_pages / v_pages
// through bt.  Writes always go to k_pages / v_pages through bt and
// page_ok.  Returns 0, a CUDA error code, or -1 (kRefused) when variant
// 2 or 3 does not take Dh.
extern "C" int prefill_attention_launch(
    const void* q, const void* k, const void* v, void* k_pages, void* v_pages,
    const void* bt, const void* starts, const void* window,
    const void* page_ok, const void* hist_k, const void* hist_v,
    const void* hist_bt, void* out, void* span, void* part_o, void* part_ml,
    int B, int C, int M, int ps, int Hq, int Hkv, int Dh, int act_kind,
    int pool_kind, int n, int es, int hist_bf16, int ck, int variant,
    int splits, float scale, float softcap, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* bt_i = (const int*)bt;
  const int* st_i = (const int*)starts;
  const int* win_i = (const int*)window;
  const int* ok_i = (const int*)page_ok;
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  if ((hist_k == nullptr) != (hist_v == nullptr) ||
      (hist_k == nullptr) != (hist_bt == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* hk = hist_k != nullptr ? hist_k : k_pages;
  const void* hv = hist_v != nullptr ? hist_v : v_pages;
  const int* hbt = hist_bt != nullptr ? (const int*)hist_bt : bt_i;
  if (act_kind == 0) {
    return launch_pool<float>(variant, pool_kind, q, k, v, k_pages, v_pages,
                              bt_i, st_i, win_i, ok_i, hk, hv, hbt, out,
                              span, part_o,
                              part_ml, B, C, M, ps, Hq, Hkv, Dh, n, es,
                              hist_bf16, ck, splits, scale, softcap, s);
  }
  if (act_kind == 1) {
    return launch_pool<__nv_bfloat16>(
        variant, pool_kind, q, k, v, k_pages, v_pages, bt_i, st_i, win_i,
        ok_i, hk, hv, hbt, out, span, part_o, part_ml, B, C, M, ps, Hq, Hkv,
        Dh, n, es,
        hist_bf16, ck, splits, scale, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
