// K4 decode_sample: the logits-head GEMM over posit-coded weights, logit
// softcap, temperature, exact top-k threshold and gumbel argmax, in two
// launches.
//
// Replaces src/repro/kernels/paged_attention.py:decode_sample
// (_decode_sample_kernel).  The TPU grid walks vocab tiles in order and
// carries the running argmax (and a top-k buffer) in scratch.  Blocks on
// Hopper run in no order, so the work is split in two passes:
//   * pass 1 (ds_logits_rows for the tied [V, D] layout, ds_logits_cols for
//     [D, V]): each block takes a vocab tile, decodes its weight codes in
//     registers right after the load (each code is read from HBM and
//     decoded exactly once), forms the tile's B x tile logits in f32 against
//     the activations staged in shared memory, applies softcap and
//     temperature, writes the logits row to a [B, V] f32 scratch and the
//     tile's best (value, index) of the sampling score,
//   * pass 2 (ds_select, one block per row): without top-k it merges the
//     tile bests, larger value first and the smaller index on ties, which
//     is the first-occurrence argmax of the whole row.  With top-k it finds
//     the exact k-th largest logit of the row by a 4 x 8-bit radix select
//     over the order-preserving integer image of the floats (multiset
//     semantics, equal to sort(l)[..., -k] for any 1 <= k <= V), then
//     rescans the stored row for argmax(noise + where(l >= kth, l, -1e30)).
//     The scratch row costs 4 bytes per logit, under 0.1% of the weight
//     bytes at command-r's vocabulary, and removes any limit on k.
//
// Bound on an H100: memory.  At B = 4, D = 8192, V = 256000 with int16
// codes the weights are 4.19 GB (1.25 ms at 3.35 TB/s) against 16.8 GFLOP
// (0.25 ms at 67 TFLOP/s f32).  The posit decode adds ~25 integer
// instructions per code on the CUDA cores, the same order as the bytes.
// The design reads each code once for all B rows: a warp owns 8 vocab
// rows, its lanes split D in 16-byte vectors, and every decoded weight
// feeds B fused multiply-adds from shared memory.  Rows of the batch
// beyond 4 take another grid row (another pass over the weights).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "posit.cuh"

namespace {

constexpr int kBT = 4;         // batch rows per pass over the weights
constexpr int kRows = 8;       // vocab rows per warp (rows layout)
constexpr int kWarps = 8;      // warps per block
constexpr int kTileRows = kRows * kWarps;  // vocab rows per block
constexpr int kTileCols = 256;             // vocab cols per block ([D, V])
constexpr int kDC = 1024;      // activation columns staged per chunk

// weight element -> f32 (codes decoded exactly); optionally rounded to
// bf16 (the fake_quant plan with bf16 activations dots in bf16)
__device__ __forceinline__ float w_value(int8_t c, int n, int es) {
  return posit_decode((uint32_t)(int)c, n, es);
}
__device__ __forceinline__ float w_value(int16_t c, int n, int es) {
  return posit_decode((uint32_t)(int)c, n, es);
}
__device__ __forceinline__ float w_value(float c, int, int) { return c; }
// bf16 weights travel as their raw bits (a plain struct, so it can sit in
// the load union); widening bf16 -> f32 is a 16-bit shift
struct Bf16Bits {
  uint16_t bits;
};
__device__ __forceinline__ float w_value(Bf16Bits c, int, int) {
  return __uint_as_float((uint32_t)c.bits << 16);
}
__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xFF800000u); }
__device__ __forceinline__ float round_bf16(float v, int on) {
  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <typename WT>
union WVec {
  uint4 raw;
  WT w[16 / sizeof(WT)];
};

// shared epilogue: softcap, temperature, scratch store, sampling score
__device__ __forceinline__ float finish_logit(float acc, float softcap,
                                              float temperature, int greedy) {
  if (softcap > 0.0f) acc = softcap * tanhf(acc / softcap);
  if (!greedy) acc = acc / fmaxf(temperature, 1e-6f);
  return acc;
}

__device__ __forceinline__ float sample_score(float l, const float* noise,
                                              size_t idx, int mode) {
  // mode 0: greedy / top-k (score = l; top-k is decided in pass 2)
  // mode 1: gumbel without top-k (score = noise + l)
  return mode == 1 ? noise[idx] + l : l;
}

// ---------------------------------------------------------------------------
// pass 1, [V, D] weights (the tied embedding): warp per 8 vocab rows
// ---------------------------------------------------------------------------
template <typename WT, bool VEC>
__global__ void __launch_bounds__(kWarps * 32) ds_logits_rows(
    const float* __restrict__ x, const WT* __restrict__ w,
    const float* __restrict__ noise, float* __restrict__ logits,
    float* __restrict__ tile_val, int* __restrict__ tile_idx, int B, int D,
    int V, int n, int es, int rbf16, float softcap, float temperature,
    int greedy, int mode) {
  constexpr int EPL = 16 / sizeof(WT);  // elements per 16-byte load
  __shared__ __align__(16) float x_s[kBT * kDC];
  __shared__ float y_s[kBT * kTileRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kBT;
  const int v0 = blockIdx.x * kTileRows + warp * kRows;

  float acc[kRows][kBT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kBT; ++j) acc[r][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kDC) {
    const int dc = min(kDC, D - d0);
    __syncthreads();
    for (int i = threadIdx.x; i < kBT * dc; i += blockDim.x) {
      const int j = i / dc, dd = i % dc;
      x_s[j * kDC + dd] = (b0 + j < B) ? x[(size_t)(b0 + j) * D + d0 + dd] : 0.0f;
    }
    __syncthreads();
    if (VEC) {
      for (int dd = lane * EPL; dd < dc; dd += 32 * EPL) {
        WVec<WT> wv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = min(v0 + r, V - 1);
          wv[r].raw = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)row * D + d0 + dd));
        }
#pragma unroll
        for (int e4 = 0; e4 < EPL; e4 += 4) {
          float4 xq[kBT];
#pragma unroll
          for (int j = 0; j < kBT; ++j)
            xq[j] = *reinterpret_cast<const float4*>(&x_s[j * kDC + dd + e4]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float w0 = round_bf16(w_value(wv[r].w[e4 + 0], n, es), rbf16);
            const float w1 = round_bf16(w_value(wv[r].w[e4 + 1], n, es), rbf16);
            const float w2 = round_bf16(w_value(wv[r].w[e4 + 2], n, es), rbf16);
            const float w3 = round_bf16(w_value(wv[r].w[e4 + 3], n, es), rbf16);
#pragma unroll
            for (int j = 0; j < kBT; ++j) {
              acc[r][j] = fmaf(xq[j].x, w0, acc[r][j]);
              acc[r][j] = fmaf(xq[j].y, w1, acc[r][j]);
              acc[r][j] = fmaf(xq[j].z, w2, acc[r][j]);
              acc[r][j] = fmaf(xq[j].w, w3, acc[r][j]);
            }
          }
        }
      }
    } else {
      for (int dd = lane; dd < dc; dd += 32) {
        float xv[kBT];
#pragma unroll
        for (int j = 0; j < kBT; ++j) xv[j] = x_s[j * kDC + dd];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = min(v0 + r, V - 1);
          const float wf = round_bf16(
              w_value(w[(size_t)row * D + d0 + dd], n, es), rbf16);
#pragma unroll
          for (int j = 0; j < kBT; ++j) acc[r][j] = fmaf(xv[j], wf, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kBT; ++j) {
      float a = acc[r][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[r][j] = a;
    }

  if (lane < kRows * kBT) {
    // lane -> (row r, batch row j); the reduced sums are in every lane
    const int r = lane / kBT, j = lane % kBT;
    float a = 0.0f;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int jj = 0; jj < kBT; ++jj)
        if (rr == r && jj == j) a = acc[rr][jj];
    const int row = v0 + r;
    const int bb = b0 + j;
    float y = neg_inf();
    if (row < V && bb < B) {
      const float l = finish_logit(a, softcap, temperature, greedy);
      logits[(size_t)bb * V + row] = l;
      y = sample_score(l, noise, (size_t)bb * V + row, mode);
    }
    y_s[j * kTileRows + warp * kRows + r] = y;
  }
  __syncthreads();
  if (threadIdx.x < kBT && b0 + (int)threadIdx.x < B) {
    const int j = threadIdx.x;
    float best = neg_inf();
    int idx = 0;
    for (int r = 0; r < kTileRows; ++r) {
      const float y = y_s[j * kTileRows + r];
      if (y > best) {  // strict: first occurrence inside the tile
        best = y;
        idx = r;
      }
    }
    const size_t t = (size_t)(b0 + j) * gridDim.x + blockIdx.x;
    tile_val[t] = best;
    tile_idx[t] = blockIdx.x * kTileRows + idx;
  }
}

// ---------------------------------------------------------------------------
// pass 1, [D, V] weights: thread per vocab column
// ---------------------------------------------------------------------------
template <typename WT>
__global__ void __launch_bounds__(kTileCols) ds_logits_cols(
    const float* __restrict__ x, const WT* __restrict__ w,
    const float* __restrict__ noise, float* __restrict__ logits,
    float* __restrict__ tile_val, int* __restrict__ tile_idx, int B, int D,
    int V, int n, int es, int rbf16, float softcap, float temperature,
    int greedy, int mode) {
  __shared__ float x_s[kBT * kDC];
  __shared__ float y_s[kBT * kTileCols];
  const int b0 = blockIdx.y * kBT;
  const int col = blockIdx.x * kTileCols + threadIdx.x;
  const int c = min(col, V - 1);
  float acc[kBT];
#pragma unroll
  for (int j = 0; j < kBT; ++j) acc[j] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += kDC) {
    const int dc = min(kDC, D - d0);
    __syncthreads();
    for (int i = threadIdx.x; i < kBT * dc; i += blockDim.x) {
      const int j = i / dc, dd = i % dc;
      x_s[j * kDC + dd] = (b0 + j < B) ? x[(size_t)(b0 + j) * D + d0 + dd] : 0.0f;
    }
    __syncthreads();
    for (int dd = 0; dd < dc; ++dd) {
      const float wf = round_bf16(w_value(w[(size_t)(d0 + dd) * V + c], n, es), rbf16);
#pragma unroll
      for (int j = 0; j < kBT; ++j) acc[j] = fmaf(x_s[j * kDC + dd], wf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kBT; ++j) {
    const int bb = b0 + j;
    float y = neg_inf();
    if (col < V && bb < B) {
      const float l = finish_logit(acc[j], softcap, temperature, greedy);
      logits[(size_t)bb * V + col] = l;
      y = sample_score(l, noise, (size_t)bb * V + col, mode);
    }
    y_s[j * kTileCols + threadIdx.x] = y;
  }
  __syncthreads();
  if (threadIdx.x < kBT && b0 + (int)threadIdx.x < B) {
    const int j = threadIdx.x;
    float best = neg_inf();
    int idx = 0;
    for (int r = 0; r < kTileCols; ++r) {
      const float y = y_s[j * kTileCols + r];
      if (y > best) {
        best = y;
        idx = r;
      }
    }
    const size_t t = (size_t)(b0 + j) * gridDim.x + blockIdx.x;
    tile_val[t] = best;
    tile_idx[t] = blockIdx.x * kTileCols + idx;
  }
}

// ---------------------------------------------------------------------------
// pass 2: merge tile bests, or exact top-k threshold + filtered argmax
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

constexpr int kSelThreads = 1024;

__device__ void block_argmax(float v, int i, float* sv, int* si, int* out) {
  // warp reduce, then across warps through shared memory
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = sv[0];
    int bi = si[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      if (better(sv[w], si[w], bv, bi)) {
        bv = sv[w];
        bi = si[w];
      }
    }
    *out = bi;
  }
}

__global__ void __launch_bounds__(kSelThreads) ds_select(
    const float* __restrict__ logits, const float* __restrict__ noise,
    const float* __restrict__ tile_val, const int* __restrict__ tile_idx,
    int* __restrict__ tok, int V, int n_tiles, int top_k) {
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ unsigned int hist[256];
  __shared__ uint32_t sel[2];  // prefix, remaining rank
  const int b = blockIdx.x;
  float bv = neg_inf();
  int bi = 0x7FFFFFFF;
  if (top_k <= 0) {
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const float v = tile_val[(size_t)b * n_tiles + t];
      const int i = tile_idx[(size_t)b * n_tiles + t];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    block_argmax(bv, bi, sv, si, tok + b);
    return;
  }
  const float* row = logits + (size_t)b * V;
  // radix select of the top_k-th largest key, most significant byte first
  if (threadIdx.x == 0) {
    sel[0] = 0u;
    sel[1] = (uint32_t)top_k;
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    const uint32_t prefix = sel[0];
    const uint32_t hi_mask = shift == 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const uint32_t k = order_key(row[v]);
      if ((k & hi_mask) == (prefix & hi_mask)) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t rank = sel[1];
      int digit = 255;
      for (; digit > 0; --digit) {
        if (hist[digit] >= rank) break;
        rank -= hist[digit];
      }
      sel[0] = prefix | ((uint32_t)digit << shift);
      sel[1] = rank;
    }
    __syncthreads();
  }
  const float kth = key_float(sel[0]);
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float l = row[v];
    const float y = noise[(size_t)b * V + v] + (l >= kth ? l : -1e30f);
    if (better(y, v, bv, bi)) {
      bv = y;
      bi = v;
    }
  }
  block_argmax(bv, bi, sv, si, tok + b);
}

template <typename WT>
int launch(const float* x, const void* w, const float* noise, float* logits,
           float* tile_val, int* tile_idx, int* tok, int B, int D, int V,
           int transpose, int n, int es, int rbf16, float softcap,
           float temperature, int greedy, int top_k, cudaStream_t s) {
  const int mode = (!greedy && top_k <= 0) ? 1 : 0;
  const int by = (B + kBT - 1) / kBT;
  int n_tiles;
  if (transpose) {
    n_tiles = (V + kTileRows - 1) / kTileRows;
    dim3 grid(n_tiles, by);
    constexpr int EPL = 16 / sizeof(WT);
    const bool vec = (D % EPL == 0) &&
                     ((reinterpret_cast<uintptr_t>(w) & 15u) == 0);
    if (vec) {
      ds_logits_rows<WT, true><<<grid, kWarps * 32, 0, s>>>(
          x, (const WT*)w, noise, logits, tile_val, tile_idx, B, D, V, n, es,
          rbf16, softcap, temperature, greedy, mode);
    } else {
      ds_logits_rows<WT, false><<<grid, kWarps * 32, 0, s>>>(
          x, (const WT*)w, noise, logits, tile_val, tile_idx, B, D, V, n, es,
          rbf16, softcap, temperature, greedy, mode);
    }
  } else {
    n_tiles = (V + kTileCols - 1) / kTileCols;
    dim3 grid(n_tiles, by);
    ds_logits_cols<WT><<<grid, kTileCols, 0, s>>>(
        x, (const WT*)w, noise, logits, tile_val, tile_idx, B, D, V, n, es,
        rbf16, softcap, temperature, greedy, mode);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ds_select<<<B, kSelThreads, 0, s>>>(logits, noise, tile_val, tile_idx, tok,
                                      V, n_tiles, greedy ? 0 : top_k);
  return (int)cudaGetLastError();
}

}  // namespace

// Tiles per batch row that the scratch arrays tile_val / tile_idx hold.
extern "C" int decode_sample_tiles(int V, int transpose) {
  return transpose ? (V + kTileRows - 1) / kTileRows
                   : (V + kTileCols - 1) / kTileCols;
}

// w_kind: 0 = int8 codes, 1 = int16 codes, 2 = float32, 3 = bfloat16.
// top_k <= 0 (or greedy) disables the top-k filter.
extern "C" int decode_sample_launch(
    const void* x, const void* w, const void* noise, void* logits,
    void* tile_val, void* tile_idx, void* tok, int B, int D, int V,
    int transpose, int w_kind, int n, int es, int rbf16, float softcap,
    float temperature, int greedy, int top_k, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const float* nz = (const float*)noise;
  float* lg = (float*)logits;
  float* tv = (float*)tile_val;
  int* ti = (int*)tile_idx;
  int* tk = (int*)tok;
  switch (w_kind) {
    case 0:
      return launch<int8_t>(xf, w, nz, lg, tv, ti, tk, B, D, V, transpose, n,
                            es, rbf16, softcap, temperature, greedy, top_k, s);
    case 1:
      return launch<int16_t>(xf, w, nz, lg, tv, ti, tk, B, D, V, transpose, n,
                             es, rbf16, softcap, temperature, greedy, top_k, s);
    case 2:
      return launch<float>(xf, w, nz, lg, tv, ti, tk, B, D, V, transpose, n,
                           es, rbf16, softcap, temperature, greedy, top_k, s);
    case 3:
      return launch<Bf16Bits>(xf, w, nz, lg, tv, ti, tk, B, D, V, transpose,
                              n, es, rbf16, softcap, temperature, greedy,
                              top_k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
