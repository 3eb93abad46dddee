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
// output in VMEM scratch.  Blocks on Hopper run in no order, and one
// block per (slot, KV head) walking the pages leaves most of the 132 SMs
// idle (32 blocks for command-r, 16 for qwen3), so the key span is split
// across blocks (flash-decoding):
//   * grid (split, KV head, slot x token tile): split s covers the keys
//     [s KS, (s + 1) KS) of the block table's span M x page size, KS
//     (the wrapper's `attention_splits`) fixed by the page size and
//     head_dim alone: whole pages, SP = max(1, 32 / page size) of them
//     (2 pages of 16 tokens), where a page fits the block's shared memory
//     and holds at most 128 keys; else a page is cut into splits of the
//     largest power of two of keys, at most 128, whose K and V rows fit
//     227 KB (64 at head_dim 256), so shared memory never grows with the
//     page size (pages of up to 1024 tokens);
//   * a block decodes the split's pieces of pages (a piece: the split's
//     keys on one page) that any of its rows visits once into shared
//     memory (16-byte loads; int8 codes through a 256-entry
//     table), then serves every query row of the group from them: the
//     G = Hq / Hkv query heads (GQA reuse), times the t_block tokens of
//     its tile for K7.  Two barriers a block, none per page;
//   * one warp per row (a block has a warp per row, up to 16 warps, and
//     two blocks fit an SM): lane l holds q dims l, l + 32, ...; a chunk of 32
//     keys' dot products is summed over the lanes by a transposing
//     butterfly (31 shuffles) that leaves key i's score on lane i, the
//     row's max and normalizer are warp reductions, and lane l
//     accumulates o over the keys for its dims, in key order;
//   * each row writes its split's (o, m, l) partial (a row that visits no
//     page of the split writes the neutral m = -2e38, l = 0, o = 0), and
//     paged_attention_merge_kernel combines a row's partials in split
//     order (one split: the block writes the output itself);
//   * masking follows the TPU kernels (paged_attention.py:93-102, :168):
//     pos <= q_pos, q_pos - pos < window, page_ok[b, p] != 0.
//
// Every value of a row is computed from that row alone, in an order fixed
// by its length, its q and its pages: a row visits exactly the pieces K3
// visits at that length (a piece that starts before the row's position
// + 1, ends inside its window, on a page with page_ok set), each in the
// split that holds it, and includes all positions of a visited piece
// (masked ones with p = 0); a split with no visited piece leaves the
// neutral partial, which the merge passes through bitwise.  The splits
// and the merge order depend on the block table's width, the page size
// and head_dim only.  So every row
// of K7 is bitwise the row K3 computes for one query at length q_pos + 1
// over the same pages, whatever T and t_block, and no row depends on the
// block's other rows.  A slot of length 0 (or a row before position 0)
// yields finite zeros (m = -2e38, l = 0 with partials).
//
// Bound on an H100: at serving shapes (4 slots, 8 KV heads, Dh = 128,
// 16-token pages, a few hundred tokens, T = 4 for K7) a call moves about
// 2 MB, under a microsecond of HBM time, so launch latency and each
// block's serial work bound it: the split keeps a block to 32 keys and
// fills the card with some 100-300 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

constexpr float kNeg = -2.0e38f;
constexpr int kMaxThreads = 512;  // a block has a warp per row, up to 16
constexpr int kMaxDh = 256;      // a lane holds at most 8 dims of a row
constexpr int kMaxChunks = 4;    // a split holds at most 128 keys
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory

// One KV element as f32 (int8 codes through the block's decode table).
__device__ __forceinline__ float kv_value(int8_t c, const float* table, int,
                                          int) {
  return table[(uint8_t)c];
}
__device__ __forceinline__ float kv_value(int16_t c, const float*, int n,
                                          int es) {
  return posit_decode((uint32_t)(int)c, n, es);
}
__device__ __forceinline__ float kv_value(float c, const float*, int, int) {
  return c;
}
__device__ __forceinline__ float kv_value(__nv_bfloat16 c, const float*, int,
                                          int) {
  return __bfloat162float(c);
}

// Element e of a 16-byte chunk w of KV elements, as f32.
template <typename KT>
__device__ __forceinline__ float chunk_value(const uint32_t* w, int e,
                                             const float* table, int n,
                                             int es);
template <>
__device__ __forceinline__ float chunk_value<int8_t>(const uint32_t* w, int e,
                                                     const float* table, int,
                                                     int) {
  return table[(w[e >> 2] >> (8 * (e & 3))) & 0xffu];
}
template <>
__device__ __forceinline__ float chunk_value<int16_t>(const uint32_t* w, int e,
                                                      const float*, int n,
                                                      int es) {
  return posit_decode(w[e >> 1] >> (16 * (e & 1)), n, es);
}
template <>
__device__ __forceinline__ float chunk_value<float>(const uint32_t* w, int e,
                                                    const float*, int, int) {
  return __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ float chunk_value<__nv_bfloat16>(
    const uint32_t* w, int e, const float*, int, int) {
  const uint32_t x = w[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}

// 16 bytes of KV elements at src (aligned) -> f32 at dst.
template <typename KT>
__device__ __forceinline__ void kv_chunk16(const KT* __restrict__ src,
                                           float* __restrict__ dst,
                                           const float* table, int n, int es) {
  constexpr int kE = 16 / sizeof(KT);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < kE; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(chunk_value<KT>(w, e, table, n, es),
                    chunk_value<KT>(w, e + 1, table, n, es),
                    chunk_value<KT>(w, e + 2, table, n, es),
                    chunk_value<KT>(w, e + 3, table, n, es));
}

// Transposing butterfly over a warp: lane l holds part[i], its share of
// key i's sum (i < 2 W).  After the step of width W, lane l keeps the
// keys of its half (bit W of l) summed over itself and lane l ^ W, in
// part[0, W); at the end key l's sum sits in part[0] of lane l, added in
// a fixed tree order.  W is a template argument so every index is a
// constant and part stays in registers.
template <int W>
__device__ __forceinline__ void transpose_sum(float* part, int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? part[i] : part[i + W];
    const float keep = upper ? part[i + W] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
  if constexpr (W > 1) transpose_sum<W / 2>(part, lane);
}

// Shared memory of a block: the int8 decode table and the split's K and V
// (kernels/paged_attention.py:split_smem_bytes mirrors it).
size_t smem_bytes(int keys, int Dh) {
  return sizeof(float) * (256 + 2 * (size_t)keys * Dh);
}

// The rows of one block: split blockIdx.x, KV head blockIdx.y, slot b,
// tokens [t0, t0 + tb) of the slot's T new tokens.  Row r = tt * G + g is
// token t0 + tt with query head h * G + g; its query sits at position
// length - T + t0 + tt.  q / out are [B, T, Hq, Dh], m / l [B, T, Hq];
// part_o [B * T * Hq, S, Dh] and part_ml [B * T * Hq, S, 2] the partials
// when S > 1.
template <typename KT>
__device__ __forceinline__ void attend_rows(
    const float* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ lengths, const int* __restrict__ window,
    const int* __restrict__ page_ok, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part_o, float* __restrict__ part_ml, int b, int T,
    int t0, int tb, int M, int ps, int Hq, int Hkv, int Dh, int n, int es,
    int KS, int S, float scale, float softcap, int vec) {
  const int s = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv, F = Hkv * Dh, R = tb * G;
  // the split's keys [k0, k0 + KS) of the span lie on pages p0 .. p0 + NP - 1
  const int keys = KS, k0 = s * KS, p0 = k0 / ps;
  const int NP = (k0 + KS - 1) / ps - p0 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  extern __shared__ float smem[];
  float* table = smem;              // [256] int8 decode table
  float* k_s = table + 256;         // [keys][Dh]
  float* v_s = k_s + keys * Dh;     // [keys][Dh]

  const int length = lengths[b];
  const long long win = window[0];
  // bit i: the row of length len visits the split's piece of page p0 + i,
  // positions [lo, hi): it starts before len, ends inside the window, and
  // the page is in the table with page_ok set (whole pages: K3's page rule)
  auto visits = [&](int len) {
    unsigned mask = 0u;
    for (int i = 0; i < NP; ++i) {
      const int p = p0 + i;
      const long long lo = max((long long)k0, (long long)p * ps);
      const long long hi = min((long long)k0 + KS, (long long)(p + 1) * ps);
      if (p < M && lo < (long long)len &&
          hi - 1 > (long long)len - 1 - win &&
          (page_ok == nullptr || page_ok[(size_t)b * M + p] != 0))
        mask |= 1u << i;
    }
    return mask;
  };
  // every thread takes the same decision: the pages some row visits
  unsigned load = 0u;
  for (int tt = 0; tt < tb; ++tt) load |= visits(length - T + t0 + tt + 1);

  if (load != 0u) {
    if (sizeof(KT) == 1)
      for (int i = threadIdx.x; i < 256; i += blockDim.x)
        table[i] = posit_decode((uint32_t)i, n, es);
    __syncthreads();
    const int per_key = vec ? Dh * (int)sizeof(KT) / 16 : Dh;
    const int step = vec ? 16 / (int)sizeof(KT) : 1;
    for (int c = threadIdx.x; c < keys * per_key; c += blockDim.x) {
      const int key = c / per_key, d = (c % per_key) * step;
      const int at = k0 + key, pl = at / ps - p0;
      if (!((load >> pl) & 1u)) continue;
      const size_t src = ((size_t)bt[(size_t)b * M + p0 + pl] * ps + at % ps) *
                             F + (size_t)h * Dh + d;
      float* kd = k_s + key * Dh + d;
      float* vd = v_s + key * Dh + d;
      if (vec) {
        kv_chunk16(k_pages + src, kd, table, n, es);
        kv_chunk16(v_pages + src, vd, table, n, es);
      } else {
        *kd = kv_value(k_pages[src], table, n, es);
        *vd = kv_value(v_pages[src], table, n, es);
      }
    }
    __syncthreads();
  }

  const int nj = (Dh + 31) / 32;
  const int nch = (keys + 31) / 32;
  unsigned dmask = 0u;  // bit j: the lane holds dim lane + 32 j
  for (int j = 0; j < nj; ++j)
    if (lane + 32 * j < Dh) dmask |= 1u << j;
  for (int r = warp; r < R; r += nwarps) {
    const int tt = r / G;
    const int len = length - T + t0 + tt + 1;  // the row's position + 1
    const unsigned vis = load ? visits(len) : 0u;
    const size_t row = ((size_t)b * T + t0 + tt) * Hq + (size_t)h * G + r % G;
    float acc[kMaxDh / 32];
#pragma unroll
    for (int j = 0; j < kMaxDh / 32; ++j) acc[j] = 0.0f;
    float mx = kNeg, lsum = 0.0f;
    if (vis != 0u) {
      float qr[kMaxDh / 32];
#pragma unroll
      for (int j = 0; j < kMaxDh / 32; ++j) {
        const int d = lane + 32 * j;
        qr[j] = (dmask >> j) & 1u ? q[row * Dh + d] * scale : 0.0f;
      }
      float sc[kMaxChunks];
      unsigned kin[kMaxChunks];  // bit i: key c * 32 + i is in a visited page
      unsigned ok = 0u;          // bit c: lane's key of chunk c is attended
      // not unrolled: one chunk at the serving page size, and the body's
      // 32-key butterfly is large
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        const int key = c * 32 + lane;
        const int pl = (k0 + key) / ps - p0;
        kin[c] = __ballot_sync(0xffffffffu,
                               key < keys && ((vis >> pl) & 1u));
        // the lane's share of the 32 keys' dot products
        float part[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float a = 0.0f;
          if ((kin[c] >> i) & 1u) {
            const float* kr = k_s + (c * 32 + i) * Dh + lane;
#pragma unroll
            for (int j = 0; j < kMaxDh / 32; ++j)
              if ((dmask >> j) & 1u) a = fmaf(qr[j], kr[32 * j], a);
          }
          part[i] = a;
        }
        transpose_sum<16>(part, lane);
        float x = part[0];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const long long pos = (long long)k0 + key;
        const bool live = ((kin[c] >> lane) & 1u) && pos < (long long)len &&
                          (long long)len - 1 - pos < win;
        sc[c] = x;
        if (live) {
          ok |= 1u << c;
          mx = fmaxf(mx, x);
        }
      }
#pragma unroll
      for (int step = 0; step < 5; ++step)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16 >> step));
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c >= nch) break;
        sc[c] = ((ok >> c) & 1u) ? expf(sc[c] - mx) : 0.0f;
        lsum += sc[c];
      }
#pragma unroll
      for (int step = 0; step < 5; ++step)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 16 >> step);
      // o over every position of the visited pages, in key order
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c >= nch) break;
#pragma unroll 4
        for (int i = 0; i < 32; ++i) {
          if (!((kin[c] >> i) & 1u)) continue;
          const float p = __shfl_sync(0xffffffffu, sc[c], i);
          const float* vr = v_s + (c * 32 + i) * Dh + lane;
#pragma unroll
          for (int j = 0; j < kMaxDh / 32; ++j)
            if ((dmask >> j) & 1u) acc[j] = fmaf(p, vr[32 * j], acc[j]);
        }
      }
    }
    if (S == 1) {
#pragma unroll
      for (int j = 0; j < kMaxDh / 32; ++j) {
        const int d = lane + 32 * j;
        if ((dmask >> j) & 1u)
          out[row * Dh + d] =
              m_out != nullptr ? acc[j] : acc[j] / fmaxf(lsum, 1e-30f);
      }
      if (m_out != nullptr && lane == 0) {
        m_out[row] = mx;
        l_out[row] = lsum;
      }
    } else {
      float* po = part_o + (row * S + s) * Dh;
#pragma unroll
      for (int j = 0; j < kMaxDh / 32; ++j) {
        const int d = lane + 32 * j;
        if ((dmask >> j) & 1u) po[d] = acc[j];
      }
      if (lane == 0) {
        part_ml[(row * S + s) * 2] = mx;
        part_ml[(row * S + s) * 2 + 1] = lsum;
      }
    }
  }
}

// K3: one token per slot (T = 1), grid (S, Hkv, B).
template <typename KT>
__global__ void __launch_bounds__(kMaxThreads, 2) paged_attention_kernel(
    const float* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ lengths, const int* __restrict__ window,
    const int* __restrict__ page_ok, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part_o, float* __restrict__ part_ml, int M, int ps,
    int Hq, int Hkv, int Dh, int n, int es, int KS, int S, float scale,
    float softcap, int vec) {
  attend_rows<KT>(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, part_o, part_ml, blockIdx.z, 1, 0, 1, M, ps,
                  Hq, Hkv, Dh, n, es, KS, S, scale, softcap, vec);
}

// K7: T tokens per slot, grid (S, Hkv, B * T / tb); block z serves slot
// z / (T / tb), tokens [(z % (T / tb)) tb, + tb).
template <typename KT>
__global__ void __launch_bounds__(kMaxThreads, 2) paged_attention_mq_kernel(
    const float* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ bt,
    const int* __restrict__ lengths, const int* __restrict__ window,
    const int* __restrict__ page_ok, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part_o, float* __restrict__ part_ml, int T, int tb,
    int M, int ps, int Hq, int Hkv, int Dh, int n, int es, int KS, int S,
    float scale, float softcap, int vec) {
  const int tiles = T / tb;
  attend_rows<KT>(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, part_o, part_ml, blockIdx.z / tiles, T,
                  (blockIdx.z % tiles) * tb, tb, M, ps, Hq, Hkv, Dh, n, es,
                  KS, S, scale, softcap, vec);
}

// A row's S partials (o, m, l) combined in split order; then the
// normalized output, or the merged partials.  One thread per (row, dim).
__global__ void paged_attention_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int rows, int S, int Dh) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * Dh) return;
  const size_t row = i / Dh;
  const int d = (int)(i % Dh);
  const float* ml = part_ml + row * S * 2;
  const float* po = part_o + row * S * Dh + d;
  float m = ml[0], l = ml[1], o = po[0];
  for (int s = 1; s < S; ++s) {
    const float ms = ml[2 * s], ls = ml[2 * s + 1];
    const float mn = fmaxf(m, ms);
    const float ca = expf(m - mn), cb = expf(ms - mn);
    l = fmaf(l, ca, ls * cb);
    o = fmaf(o, ca, po[(size_t)s * Dh] * cb);
    m = mn;
  }
  if (m_out != nullptr) {
    out[i] = o;
    if (d == 0) {
      m_out[row] = m;
      l_out[row] = l;
    }
  } else {
    out[i] = o / fmaxf(l, 1e-30f);
  }
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
           float* out, float* m_out, float* l_out, float* part_o,
           float* part_ml, int B, int M, int ps, int T, int tb, int Hq,
           int Hkv, int Dh, int n, int es, int KS, int S, float scale,
           float softcap, bool mq, cudaStream_t s) {
  const size_t smem = smem_bytes(KS, Dh);
  // 16-byte loads need every (page, token, head) row of codes aligned
  const int vec = (Dh * sizeof(KT)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // a warp per query row of the block, up to kMaxThreads
  const int threads = min(32 * tb * (Hq / Hkv), kMaxThreads);
  if (mq) {
    cudaError_t e = allow_smem(paged_attention_mq_kernel<KT>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(S, Hkv, B * (T / tb));
    paged_attention_mq_kernel<KT><<<grid, threads, smem, s>>>(
        (const float*)q, (const KT*)k, (const KT*)v, bt, lengths, window,
        page_ok, out, m_out, l_out, part_o, part_ml, T, tb, M, ps, Hq, Hkv,
        Dh, n, es, KS, S, scale, softcap, vec);
  } else {
    cudaError_t e = allow_smem(paged_attention_kernel<KT>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(S, Hkv, B);
    paged_attention_kernel<KT><<<grid, threads, smem, s>>>(
        (const float*)q, (const KT*)k, (const KT*)v, bt, lengths, window,
        page_ok, out, m_out, l_out, part_o, part_ml, M, ps, Hq, Hkv, Dh, n,
        es, KS, S, scale, softcap, vec);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const int rows = B * T * Hq;
  const size_t total = (size_t)rows * Dh;
  paged_attention_merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_o, part_ml, out, m_out, l_out, rows, S, Dh);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* bt, const void* lengths, const void* window,
             const void* page_ok, void* out, void* m_out, void* l_out,
             void* part_o, void* part_ml, int B, int M, int ps, int T, int tb,
             int Hq, int Hkv, int Dh, int kv_kind, int n, int es, int KS,
             int S, float scale, float softcap, bool mq, void* stream) {
  // a split is whole pages (at most 32) or a piece of one (it then touches
  // at most two pages); S covers the span once
  const long long span = (long long)M * ps;
  if (T < 1 || tb < 1 || T % tb != 0 || Hkv < 1 || Hq % Hkv != 0 ||
      Dh < 1 || Dh > kMaxDh || ps < 1 || KS < 1 || KS > 32 * kMaxChunks ||
      (KS % ps == 0 ? KS / ps > 32 : KS > ps) ||
      smem_bytes(KS, Dh) > kMaxSmem ||
      S != (span + KS - 1) / KS + (M == 0) ||
      (S > 1 && (part_o == nullptr || part_ml == nullptr))) {
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
  float* po = (float*)part_o;
  float* pml = (float*)part_ml;
#define K3_LAUNCH(KT)                                                        \
  return launch<KT>(q, k_pages, v_pages, bt_i, len_i, win_i, ok_i, o, mo,   \
                    lo, po, pml, B, M, ps, T, tb, Hq, Hkv, Dh, n, es, KS, S, \
                    scale, softcap, mq, s)
  switch (kv_kind) {
    case 0: K3_LAUNCH(int8_t);
    case 1: K3_LAUNCH(int16_t);
    case 2: K3_LAUNCH(float);
    case 3: K3_LAUNCH(__nv_bfloat16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K3_LAUNCH
}

}  // namespace

// kv_kind: 0 = int8 codes, 1 = int16 codes, 2 = float32, 3 = bfloat16.
// m_out / l_out non-null selects the unnormalized partials output.  KS
// keys per split, S = max(1, ceil(M * ps / KS)) splits (the wrapper's
// `attention_splits`); with S > 1, part_o [B * T * Hq, S, Dh] and part_ml
// [B * T * Hq, S, 2] f32 scratch.
// K3: q / out [B, Hq, Dh], m / l [B, Hq].
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* lengths, const void* window, const void* page_ok, void* out,
    void* m_out, void* l_out, void* part_o, void* part_ml, int B, int M,
    int ps, int Hq, int Hkv, int Dh, int kv_kind, int n, int es, int KS,
    int S, float scale, float softcap, void* stream) {
  return dispatch(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, part_o, part_ml, B, M, ps, 1, 1, Hq, Hkv, Dh,
                  kv_kind, n, es, KS, S, scale, softcap, false, stream);
}

// K7: q / out [B, T, Hq, Dh], m / l [B, T, Hq]; t_block divides T.
extern "C" int paged_attention_mq_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* bt,
    const void* lengths, const void* window, const void* page_ok, void* out,
    void* m_out, void* l_out, void* part_o, void* part_ml, int B, int M,
    int ps, int T, int t_block, int Hq, int Hkv, int Dh, int kv_kind, int n,
    int es, int KS, int S, float scale, float softcap, void* stream) {
  return dispatch(q, k_pages, v_pages, bt, lengths, window, page_ok, out,
                  m_out, l_out, part_o, part_ml, B, M, ps, T, t_block, Hq,
                  Hkv, Dh, kv_kind, n, es, KS, S, scale, softcap, true,
                  stream);
}

// merge_attn_partials: the log-sum-exp merge of a kv_pages-sharded pool's
// per-shard K3 / K7 partials (replaces the reference's plain
// kernels/ops.py:244 merge_attn_partials, a pmax and two psums over the
// shard axis).  Shard s's partials o [S, rows, Dh], m / l [S, rows] are
// rescaled to the rows' global max and summed in shard order, then
// normalized: w = exp(m_s - max), l = sum l_s w, o = sum o_s w,
// out = o / max(l, 1e-30).  The products and sums are rounded one by one
// (no fused multiply-add), and the division is K3's finalize, so a row
// whose pages all lie on one shard comes out bitwise K3's unsharded
// output: its shard has w = 1 and every other shard m = -2e38, l = 0,
// o = 0, hence w = 0.  One thread per (row, dim).
namespace {

__global__ void attn_shard_merge_kernel(const float* __restrict__ o,
                                        const float* __restrict__ m,
                                        const float* __restrict__ l,
                                        float* __restrict__ out, int S,
                                        long long rows, int Dh) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * Dh) return;
  const long long row = i / Dh;
  float mx = m[row];
  for (int s = 1; s < S; ++s) mx = fmaxf(mx, m[s * rows + row]);
  float lt = 0.0f, ot = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(m[s * rows + row] - mx);
    lt = __fadd_rn(lt, __fmul_rn(l[s * rows + row], w));
    ot = __fadd_rn(ot, __fmul_rn(o[s * rows * Dh + i], w));
  }
  out[i] = ot / fmaxf(lt, 1e-30f);
}

}  // namespace

// o [S, rows, Dh], m / l [S, rows] f32 (S shards' partials, contiguous);
// out [rows, Dh] f32.
extern "C" int attn_shard_merge_launch(const void* o, const void* m,
                                       const void* l, void* out, int S,
                                       long long rows, int Dh, void* stream) {
  const long long total = rows * Dh;
  if (S < 1 || total <= 0) return S < 1 ? (int)cudaErrorInvalidValue : 0;
  attn_shard_merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)o, (const float*)m, (const float*)l, (float*)out, S,
      rows, Dh);
  return (int)cudaGetLastError();
}
