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
//     decoded exactly once for up to 16 batch rows), forms the tile's
//     logits in f32 against the activations staged in shared memory,
//     applies softcap and temperature, writes the logits rows to a [B, V]
//     f32 scratch and the tile's best (value, index) of the sampling score;
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
// Bound on an H100: at B = 4, D = 8192, V = 256000 with int16 codes the
// weights are 4.19 GB (1.25 ms at 3.35 TB/s) against 16.8 GFLOP (0.25 ms
// at 67 TFLOP/s f32).  The decode is the other limit: each code feeds only
// B FMAs, so the SMs' integer pipes (64 lanes an SM) bound the pass before
// HBM does unless the decode is short.  The design:
//   * the weight format and the bf16 rounding of the fake_quant plan are
//     template arguments: int16 P(16,2) codes (every serving head, the
//     wrapper's "p16_2" variant) decode through posit_decode_fast<16, 2>
//     (code_rows.cuh, about 17 operations); other formats ("posit") through
//     the run-time decode; f32 and bf16 weights ("f32", "bf16") are read
//     as they are.  No per-code run-time select is left in the inner loop;
//   * up to 16 batch rows share one pass over the weights (4 where B <= 4,
//     which keeps the accumulators of 8 vocab rows a warp in registers);
//     more rows take further grid rows;
//   * [V, D]: a warp owns R vocab rows (8 at 4 batch rows, 4 at 16, 64 a
//     block either way); its lanes read 16-byte vectors along D.  The
//     activations are staged with each 16-byte vector's groups of four
//     values lane-contiguous, so each float4 read is free of bank
//     conflicts and feeds 4 x R FMAs;
//   * [D, V] (qwen3's untied head): a block owns 256 vocab columns, 8
//     codes a lane in one 16-byte load along V; its 8 warps take the D
//     rows in turn (4 rows in flight), each activation row is one
//     broadcast float4 per 4 batch rows, and the warps' partial sums are
//     added in warp order through shared memory.
// A row's sum order depends on D (and the layout) alone, never on B or on
// the other rows: the lanes' D slices and the warps' row turns are the
// same at 4 and at 16 rows a pass, so rows 0-3 give the same logits, and
// tokens, in a batch of 16 as in a batch of 4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "code_rows.cuh"
#include "posit.cuh"

namespace {

// weight element types and their decode to f32
struct DecodeF32 {
  __device__ __forceinline__ float operator()(uint32_t b) const {
    return __uint_as_float(b);
  }
};
struct DecodeBf16 {  // bf16 -> f32 is a 16-bit shift of the raw bits
  __device__ __forceinline__ float operator()(uint32_t b) const {
    return __uint_as_float(b << 16);
  }
};
template <typename TT, typename Dec>
struct Weights {
  using T = TT;
  Dec dec;
  __device__ __forceinline__ float operator()(uint32_t raw) const {
    return dec(raw);
  }
};

// the fake_quant plan with bf16 activations dots in bf16: weights rounded
template <bool RB>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (RB) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xFF800000u); }

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

// the first-occurrence best of one batch row's scores y[0, n) over this
// block's tile, into tile_val / tile_idx[row, tile]
__device__ __forceinline__ void tile_best(const float* y, int n, int row,
                                          int base, float* tile_val,
                                          int* tile_idx) {
  float best = neg_inf();
  int idx = 0;
  for (int r = 0; r < n; ++r) {
    if (y[r] > best) {  // strict: first occurrence inside the tile
      best = y[r];
      idx = r;
    }
  }
  const size_t t = (size_t)row * gridDim.x + blockIdx.x;
  tile_val[t] = best;
  tile_idx[t] = base + idx;
}

// ---------------------------------------------------------------------------
// pass 1, [V, D] weights (the tied embedding): a warp per R vocab rows
// ---------------------------------------------------------------------------
// 8 vocab rows a warp at 4 batch rows; at 16 rows 4 a warp and 16 warps
// a block (8 rows a warp, or 8 warps of 4 rows, ran 1.4-1.6x slower on an
// H100: fewer warps in flight)
template <int BT>
struct RowsGeom;
template <>
struct RowsGeom<4> {
  static constexpr int R = 8, NW = 8, DC = 1024;
};
template <>
struct RowsGeom<16> {
  static constexpr int R = 4, NW = 16, DC = 512;
};
constexpr int kTileRows = 64;  // R x NW of every geometry

template <typename W, bool RB, int BT, bool VEC>
__global__ void __launch_bounds__(RowsGeom<BT>::NW * 32) ds_logits_rows(
    const float* __restrict__ x, const typename W::T* __restrict__ w, W dec,
    const float* __restrict__ noise, float* __restrict__ logits,
    float* __restrict__ tile_val, int* __restrict__ tile_idx, int B, int D,
    int V, float softcap, float temperature, int greedy, int mode) {
  using T = typename W::T;
  constexpr int R = RowsGeom<BT>::R, NW = RowsGeom<BT>::NW;
  constexpr int DC = RowsGeom<BT>::DC;  // a multiple of 32 x EPL
  constexpr int EPL = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int NV = DC / EPL;          // 16-byte vectors per staged chunk
  static_assert(R * NW == kTileRows, "64 vocab rows a block");
  __shared__ __align__(16) float x_s[BT * DC];
  __shared__ float y_s[BT * kTileRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * BT;
  const int v0 = blockIdx.x * kTileRows + warp * R;

  float acc[R][BT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < BT; ++j) acc[r][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * dc; i += NW * 32) {
      const int j = i / dc, d = i % dc;
      const float v = b0 + j < B ? x[(size_t)(b0 + j) * D + d0 + d] : 0.0f;
      if constexpr (VEC) {
        // vector d / EPL, its group of four (d % EPL) / 4: groups of the
        // same index sit lane-contiguous
        const int e = d % EPL;
        x_s[j * DC + ((e >> 2) * NV + d / EPL) * 4 + (e & 3)] = v;
      } else {
        x_s[j * DC + d] = v;
      }
    }
    __syncthreads();
    if constexpr (VEC) {
      for (int v = lane; v * EPL < dc; v += 32) {
        uint32_t raw[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = min(v0 + r, V - 1);
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)row * D + d0 + v * EPL));
          raw[r][0] = q.x; raw[r][1] = q.y; raw[r][2] = q.z; raw[r][3] = q.w;
        }
#pragma unroll
        for (int g = 0; g < EPL / 4; ++g) {
          float wf[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              wf[r][e] = rnd<RB>(dec(elem<T>(raw[r], 4 * g + e)));
#pragma unroll
          for (int j = 0; j < BT; ++j) {
            const float4 xq = *reinterpret_cast<const float4*>(
                &x_s[j * DC + (g * NV + v) * 4]);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][j] = fmaf(xq.x, wf[r][0], acc[r][j]);
              acc[r][j] = fmaf(xq.y, wf[r][1], acc[r][j]);
              acc[r][j] = fmaf(xq.z, wf[r][2], acc[r][j]);
              acc[r][j] = fmaf(xq.w, wf[r][3], acc[r][j]);
            }
          }
        }
      }
    } else {
      for (int dd = lane; dd < dc; dd += 32) {
        float xv[BT];
#pragma unroll
        for (int j = 0; j < BT; ++j) xv[j] = x_s[j * DC + dd];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = min(v0 + r, V - 1);
          const float wf = rnd<RB>(dec(raw_bits(w[(size_t)row * D + d0 + dd])));
#pragma unroll
          for (int j = 0; j < BT; ++j) acc[r][j] = fmaf(xv[j], wf, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      float a = acc[r][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[r][j] = a;
    }

  // every lane holds the sums; lane p % 32 finishes (row r, batch row j)
  // for p = r * BT + j
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (((r * BT + j) & 31) != lane) continue;
      const int row = v0 + r;
      const int bb = b0 + j;
      float y = neg_inf();
      if (row < V && bb < B) {
        const float l = finish_logit(acc[r][j], softcap, temperature, greedy);
        logits[(size_t)bb * V + row] = l;
        y = sample_score(l, noise, (size_t)bb * V + row, mode);
      }
      y_s[j * kTileRows + warp * R + r] = y;
    }
  __syncthreads();
  if (threadIdx.x < BT && b0 + (int)threadIdx.x < B)
    tile_best(y_s + threadIdx.x * kTileRows, kTileRows, b0 + threadIdx.x,
              blockIdx.x * kTileRows, tile_val, tile_idx);
}

// ---------------------------------------------------------------------------
// pass 1, [D, V] weights: 256 vocab columns a block, its warps take D rows
// ---------------------------------------------------------------------------
constexpr int kColsWarps = 8;
constexpr int kTileCols = 32 * kCols;  // vocab columns a block
constexpr int kColsDC = 256;           // D rows staged per chunk
constexpr int kColsUnroll = 4;         // D rows in flight per thread

template <typename W, bool RB, int BT>
__global__ void __launch_bounds__(kColsWarps * 32) ds_logits_cols(
    const float* __restrict__ x, const typename W::T* __restrict__ w, W dec,
    const float* __restrict__ noise, float* __restrict__ logits,
    float* __restrict__ tile_val, int* __restrict__ tile_idx, int B, int D,
    int V, float softcap, float temperature, int greedy, int mode, int vec) {
  using T = typename W::T;
  __shared__ __align__(16) float x_s[kColsDC * BT];  // [d][j]
  __shared__ __align__(16) float red[BT * kTileCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * BT;
  const int c0 = blockIdx.x * kTileCols;
  const int col = c0 + lane * kCols;
  const int ncols = V - col;

  float acc[BT][kCols];
#pragma unroll
  for (int j = 0; j < BT; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kColsDC) {
    const int dc = min(kColsDC, D - d0);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * dc; i += kColsWarps * 32) {
      const int dd = i / BT, j = i % BT;
      x_s[i] = b0 + j < B ? x[(size_t)(b0 + j) * D + d0 + dd] : 0.0f;
    }
    __syncthreads();
    // warp w takes the rows d = w (mod 8) in increasing order
    for (int r0 = warp; r0 < dc; r0 += kColsWarps * kColsUnroll) {
      Row8<T> run[kColsUnroll];
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        const int r = r0 + u * kColsWarps;
        if (r < dc && ncols > 0)
          run[u].load(w + (size_t)(d0 + r) * V + col, ncols, vec != 0);
        else
          run[u].zero();
      }
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        const int r = r0 + u * kColsWarps;
        if (r >= dc) continue;
        float wf[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) wf[c] = rnd<RB>(dec(run[u].code(c)));
#pragma unroll
        for (int j = 0; j < BT; j += 4) {
          const float4 xq = *reinterpret_cast<const float4*>(&x_s[r * BT + j]);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[j][c] = fmaf(xq.x, wf[c], acc[j][c]);
            acc[j + 1][c] = fmaf(xq.y, wf[c], acc[j + 1][c]);
            acc[j + 2][c] = fmaf(xq.z, wf[c], acc[j + 2][c]);
            acc[j + 3][c] = fmaf(xq.w, wf[c], acc[j + 3][c]);
          }
        }
      }
    }
  }

  // the warps' partial sums added in warp order: red = ((w0 + w1) + w2) ...
  for (int ww = 0; ww < kColsWarps; ++ww) {
    if (warp == ww) {
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        float4* p = reinterpret_cast<float4*>(&red[j * kTileCols + lane * kCols]);
        float4 lo = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        float4 hi = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
        if (ww > 0) {
          const float4 a = p[0], b = p[1];
          lo = make_float4(a.x + lo.x, a.y + lo.y, a.z + lo.z, a.w + lo.w);
          hi = make_float4(b.x + hi.x, b.y + hi.y, b.z + hi.z, b.w + hi.w);
        }
        p[0] = lo;
        p[1] = hi;
      }
    }
    __syncthreads();
  }

  // thread t finishes column c0 + t of every batch row
  const int cc = c0 + threadIdx.x;
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    const int bb = b0 + j;
    float y = neg_inf();
    if (cc < V && bb < B) {
      const float l = finish_logit(red[j * kTileCols + threadIdx.x], softcap,
                                   temperature, greedy);
      logits[(size_t)bb * V + cc] = l;
      y = sample_score(l, noise, (size_t)bb * V + cc, mode);
    }
    red[j * kTileCols + threadIdx.x] = y;
  }
  __syncthreads();
  if (threadIdx.x < BT && b0 + (int)threadIdx.x < B)
    tile_best(red + threadIdx.x * kTileCols, kTileCols, b0 + threadIdx.x, c0,
              tile_val, tile_idx);
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


struct Launch {
  const float* x;
  const void* w;
  const float* noise;
  float* logits;
  float* tile_val;
  int* tile_idx;
  int* tok;
  int B, D, V, transpose;
  float softcap, temperature;
  int greedy, top_k;
  cudaStream_t s;
};

// pass 1 at 16 batch rows a pass where B > 4, else 4; then pass 2
template <typename W, bool RB>
int launch(const Launch& a, W dec) {
  using T = typename W::T;
  const int mode = (!a.greedy && a.top_k <= 0) ? 1 : 0;
  const bool wide = a.B > 4;
  const T* w = static_cast<const T*>(a.w);
  int n_tiles;
  if (a.transpose) {
    n_tiles = (a.V + kTileRows - 1) / kTileRows;
    const bool vec = a.D % (16 / (int)sizeof(T)) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15u) == 0;
#define K4_ROWS(BT, VEC)                                                    \
  ds_logits_rows<W, RB, BT, VEC>                                            \
      <<<dim3(n_tiles, (a.B + BT - 1) / BT), RowsGeom<BT>::NW * 32, 0,      \
         a.s>>>(a.x, w, dec, a.noise, a.logits, a.tile_val, a.tile_idx, a.B, \
                a.D, a.V, a.softcap, a.temperature, a.greedy, mode)
    if (vec && wide)
      K4_ROWS(16, true);
    else if (vec)
      K4_ROWS(4, true);
    else
      K4_ROWS(4, false);
#undef K4_ROWS
  } else {
    n_tiles = (a.V + kTileCols - 1) / kTileCols;
    const int vec = a.V % kCols == 0 &&
                    reinterpret_cast<uintptr_t>(w) % (kCols * sizeof(T)) == 0;
#define K4_COLS(BT)                                                          \
  ds_logits_cols<W, RB, BT>                                                  \
      <<<dim3(n_tiles, (a.B + BT - 1) / BT), kColsWarps * 32, 0, a.s>>>(     \
          a.x, w, dec, a.noise, a.logits, a.tile_val, a.tile_idx, a.B, a.D, \
          a.V, a.softcap, a.temperature, a.greedy, mode, vec)
    if (wide)
      K4_COLS(16);
    else
      K4_COLS(4);
#undef K4_COLS
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ds_select<<<a.B, kSelThreads, 0, a.s>>>(a.logits, a.noise, a.tile_val,
                                          a.tile_idx, a.tok, a.V, n_tiles,
                                          a.greedy ? 0 : a.top_k);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_rb(const Launch& a, W dec, int rbf16) {
  return rbf16 ? launch<W, true>(a, dec) : launch<W, false>(a, dec);
}

}  // namespace

// Tiles per batch row that the scratch arrays tile_val / tile_idx hold.
extern "C" int decode_sample_tiles(int V, int transpose) {
  return transpose ? (V + kTileRows - 1) / kTileRows
                   : (V + kTileCols - 1) / kTileCols;
}

// w_kind: 0 = int8 codes, 1 = int16 codes, 2 = float32, 3 = bfloat16.
// variant (the wrapper's `sample_variant`): 0 = posit codes of (n, es)
// with the run-time decode, 1 = int16 P(16,2) codes with the compile-time
// decode, 2 = f32 weights, 3 = bf16 weights.  rbf16 rounds the weights to
// bf16 (the fake_quant plan with bf16 activations).  top_k <= 0 (or
// greedy) disables the top-k filter.
extern "C" int decode_sample_launch(
    const void* x, const void* w, const void* noise, void* logits,
    void* tile_val, void* tile_idx, void* tok, int B, int D, int V,
    int transpose, int w_kind, int variant, int n, int es, int rbf16,
    float softcap, float temperature, int greedy, int top_k, void* stream) {
  const Launch a{(const float*)x, w, (const float*)noise, (float*)logits,
                 (float*)tile_val, (int*)tile_idx, (int*)tok, B, D, V,
                 transpose, softcap, temperature, greedy, top_k,
                 reinterpret_cast<cudaStream_t>(stream)};
  switch (variant) {
    case 0:
      if (w_kind == 0)
        return launch_rb(a, Weights<int8_t, DecodeRuntime>{{n, es}}, rbf16);
      if (w_kind == 1)
        return launch_rb(a, Weights<int16_t, DecodeRuntime>{{n, es}}, rbf16);
      return (int)cudaErrorInvalidValue;
    case 1:
      if (w_kind != 1 || n != 16 || es != 2) return (int)cudaErrorInvalidValue;
      return launch_rb(a, Weights<int16_t, DecodeP16_2>{}, rbf16);
    case 2:
      if (w_kind != 2) return (int)cudaErrorInvalidValue;
      return launch_rb(a, Weights<float, DecodeF32>{}, rbf16);
    case 3:
      // bf16 weights are bf16 already: rounding them again changes nothing
      if (w_kind != 3) return (int)cudaErrorInvalidValue;
      return launch<Weights<uint16_t, DecodeBf16>, false>(a, {});
    default:
      return (int)cudaErrorInvalidValue;
  }
}
