// posit_gemv_f: float activations x posit-coded weights -> f32 at decode
// rows (M <= 8), each weight code decoded next to its dot: the float
// weight path's GEMV.
//
// Replaces, on the float weight path, the TPU kernel
// src/repro/kernels/posit_codec.py:55 decode (its pl.pallas_call at :66),
// whose f32 output the reference's ops.matmul_posit_weights
// (src/repro/kernels/ops.py:268) hands to jnp.dot.  Decoding the whole
// operand first moves 10 bytes a weight (2 read and 4 written by the
// decode, 4 read by the product); here every code is read once, 2 bytes.
//
// Bound on an H100: at M <= 8 each code is used at most 8 times, so HBM
// bytes bound the call: one command-r-35b layer's 7 projections are
// 704.6 M codes, 1.41 GB, 0.42 ms at 3.35 TB/s; the tied [256000, 8192]
// head 4.19 GB, 1.25 ms.  To stay under that, the integer pipes (64 lanes
// an SM, some 16.7 T operations a second) may spend about 10 operations a
// code on everything, and all the SM's issue slots about 20.
// posit_decode_fast<16, 2> alone takes some 17 integer operations, so
// int16 P(16,2) codes (every serving checkpoint's weights) are decoded by
// the table of p16_2_table.cuh instead: an index, one PRMT, one 4-byte
// shared-memory load, two operations to unpack it and one FFMA a code
// (scripts/time_gemv_decode.py times the candidates alone and counts the
// SASS; chip_smoke.py counts this kernel's hot loop); other formats keep
// the run-time decode (posit_decode, some 30).  Products of a float
// activation and a decoded code round once in the FMA, as in any f32
// GEMM; only the order of the K-long sums differs from torch.matmul on
// the decoded weights (held to posit_matmul.sum_bound with fmt_a None).
// The other limit is bytes in flight: int16 codes stream through a ring
// of 4 slots in shared memory (cp.async, each lane its own 16 bytes a
// row, no barrier), 3 slots (48 KB a block) in flight while a lane
// decodes the fourth.
//
// Activations arrive as f32 or bf16 and are widened in the kernel (exact),
// so no cast kernel runs before it.  Two weight layouts, 256 threads a
// block, each lane reading 8 codes with one 16-byte load; the decode table
// in shared memory:
//   * [K, N] contiguous (every projection): a block owns 64 columns and
//     one K split (the wrapper's `gemv_f_split_k`).  8 lanes cover a
//     row's 64 columns, so a warp-load takes 4 rows of 128 bytes and the
//     block 32 rows a step; a ring slot is 4 steps.  Splits under 1024
//     rows, int8 codes and ragged tiles load into registers instead, 8
//     steps at a time.  The split's activation rows sit in shared memory
//     as f32; the lanes of a row read the same ones (a broadcast).  The 32
//     row-lane groups' partial sums are added in group order through
//     shared memory;
//   * the transpose of a contiguous [N, K] (the tied head, [V, D] read as
//     [D, V]; no transposed copy of the codes is ever made): a block owns
//     64 output rows and one K split of 2048 codes (`split_k_t`).  Warp w
//     owns the split's 256 codes from w 256 and lane l 8 of them, whose
//     activations it holds in registers for every row; the warp reads a
//     row's 256 codes with one 512-byte warp-load (a ring slot is 4 rows),
//     and adds its lanes' sums of 4 rows x M by a reduce-scatter (about
//     one shuffle a sum); the 8 warps' sums of a row are added in warp
//     order through shared memory.
// The geometry depends on (N, K) alone, and every sum runs in an order
// fixed by it: row m's result does not depend on M or on the other rows,
// and two calls on the same inputs are bitwise equal (no float atomics),
// so several calls over one weight (the speculative verify's tokens, each
// at the decode step's M) give what one call gives.
//
// One launch a call.  With S > 1 K splits, each block writes its split's
// [M, 64] partial sums to an [S, M, N] scratch, and the last block of a
// tile to finish (an atomic ticket a tile) adds the S partials in split
// order and writes the output; it then sets its ticket back to 0, so the
// tickets (kept by the wrapper, zero between calls) need no memset.
#include <cuda_runtime.h>

#include <cstdint>

#include "code_rows.cuh"
#include "gemv_rows.cuh"
#include "p16_2_table.cuh"
#include "posit.cuh"

namespace {

constexpr int kRefused = -1;  // a configuration the launcher does not take
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // columns ([K, N]) or output rows (^T) a block
// [K, N]
constexpr int kRowLanes = kTile / kCols;               // 8 lanes share a row
constexpr int kRowsWarp = 32 / kRowLanes;              // 4 rows a warp-load
constexpr int kRowsStep = kWarps * kRowsWarp;          // 32 rows a block step
constexpr int kInFlight = 8;                           // row loads a lane
constexpr int kRowsIter = kRowsStep * kInFlight;       // 256 rows an iteration
constexpr int kRowGroups = kRowsStep;                  // partial rows summed
// int16 codes over whole tiles stream through a ring of kStages slots in
// shared memory (cp.async, each lane its own 16 bytes a row): a slot is
// kSlotSteps row steps, and kStages - 1 slots are in flight
constexpr int kStages = 4;
constexpr int kSlotSteps = 4;
constexpr int kSlotRows = kSlotSteps * kRowsStep;      // 128 rows a slot
constexpr int kRingBytes = kStages * kSlotSteps * kThreads * 16;  // 64 KB
// [K, N] splits of fewer rows keep the loads in registers: their few
// slots would not fill the ring, and its 64 KB would cost occupancy
constexpr int kRingMinRows = 1024;
static_assert(kRingBytes >= 4 * kRowGroups * 8 * kTile, "red fits the ring");
// transposed
constexpr int kTSpan = 32 * kCols;          // 256 codes: a warp's K chunk
constexpr int kTSplit = kWarps * kTSpan;    // 2048 codes: a block's K split
constexpr int kTGroup = 4;                  // output rows a warp takes at once
static_assert(kStages * kTGroup * kThreads * 16 == kRingBytes, "t ring");

// the decoder's table into shared memory (a static array, so its loads
// address it by an immediate)
template <typename Codes>
__device__ __forceinline__ void stage_table(Codes& codes,
                                            const uint32_t* table,
                                            uint32_t* s_tab, int M) {
  if constexpr (Codes::kTableEntries > 0) {
    for (int i = threadIdx.x; i < Codes::kTableEntries; i += kThreads)
      s_tab[i] = table[i];
  }
  codes.init(s_tab, (uint32_t)M >> 31);  // M >= 0: a run-time 0
}

template <int MR>
__device__ __forceinline__ void load_rows(const float* p, float (&av)[MR]) {
  if constexpr (MR % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MR / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      av[4 * q] = t.x; av[4 * q + 1] = t.y; av[4 * q + 2] = t.z;
      av[4 * q + 3] = t.w;
    }
  } else if constexpr (MR == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    av[0] = t.x; av[1] = t.y;
  } else {
    av[0] = p[0];
  }
}

// After a block wrote its split's partial tile (S > 1): the last block of
// the tile to finish adds the S partials of its M x kTile outputs in split
// order into `out` and sets the tile's ticket back to 0.
__device__ __forceinline__ void finish_tile(const float* partial, float* out,
                                            int* tickets, int n0, int M,
                                            int N, int S) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.x, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * kTile; i += kThreads) {
    const int m = i / kTile, n = n0 + i % kTile;
    if (n >= N) continue;
    const float* p = partial + (size_t)m * N + n;
    float sum = __ldcg(p);
#pragma unroll 8
    for (int s = 1; s < S; ++s) sum += __ldcg(p + (size_t)s * M * N);
    out[(size_t)m * N + n] = sum;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

// A Row8 of code 1.0 in every slot (0x4000 in each 16-bit half; 0x40 in
// each byte): what the kernels read where a row or a column lies past the
// operand, so the table decoder never takes its full decode there.
template <typename BT>
__device__ __forceinline__ void fill_ones(Row8<BT>& r) {
#pragma unroll
  for (int i = 0; i < Row8<BT>::kWords; ++i)
    r.w[i] = sizeof(BT) == 2 ? 0x40004000u : 0x40404040u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One decoded row multiplied into acc: acc[m][j] += as[r][m] v[j].
template <int MR>
__device__ __forceinline__ void kn_fma(const float* as, int r,
                                       const float (&v)[kCols],
                                       float (&acc)[MR][kCols]) {
  float av[MR];
  load_rows<MR>(as + r * MR, av);
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[m][j] = fmaf(av[m], v[j], acc[m][j]);
}

// One iteration of the [K, N] kernel: kInFlight row loads a lane (rows
// r0 + u 32 + group of the split), then each row decoded and multiplied
// into acc.  kChecked: rows past nk and columns past N read as code 1.0
// (they add nothing: their products are skipped or never written), and a
// row step wholly past nk is skipped (block-uniform); otherwise every
// row and column is in range and loads are 16-byte vectors.
template <bool kChecked, int MR, typename BT, typename Codes>
__device__ __forceinline__ void kn_iteration(
    const BT* __restrict__ p, size_t step, const float* as,
    const Codes& codes, int r0, int group, int nk, int ncols, bool vec,
    float (&acc)[MR][kCols]) {
  Row8<BT> rows[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    if (!kChecked)
      rows[u].load(p + u * step, kCols, true);
    else if (r0 + u * kRowsStep + group < nk && ncols > 0)
      rows[u].load(p + u * step, ncols, vec);
    else
      fill_ones(rows[u]);
  }
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int r = r0 + u * kRowsStep + group;
    if (kChecked && r0 + u * kRowsStep >= nk) break;  // block-uniform
    float v[kCols];
    codes.row(rows[u], v);  // every lane of the warp: the decoder may vote
    if (!kChecked || r < nk) kn_fma<MR>(as, r, v, acc);
  }
}

// [K, N] weights: one (64-column tile, K split).
template <int MR, typename Act, typename BT, typename Codes>
__global__ void __launch_bounds__(kThreads) posit_gemv_f_kernel(
    Act act, const BT* __restrict__ b, Codes codes,
    const uint32_t* __restrict__ table, float* __restrict__ out,
    float* __restrict__ partial, int* __restrict__ tickets, int M, int N,
    int K, int KS, int S, int vec) {
  extern __shared__ float4 smem4[];
  __shared__ uint32_t s_tab[Codes::kTableEntries > 0 ? Codes::kTableEntries
                                                     : 1];
  // [the ring (int16 codes, KS >= kRingMinRows)] [the split's activation
  // rows]; the row-lane groups' sums reuse the start afterwards
  const bool ring_layout = sizeof(BT) == 2 && KS >= kRingMinRows;
  uint4* ring = reinterpret_cast<uint4*>(smem4);
  float* as =
      reinterpret_cast<float*>(smem4) + (ring_layout ? kRingBytes / 4 : 0);
  const int n0 = blockIdx.x * kTile, split = blockIdx.y;
  const int k0 = split * KS;
  const int nk = max(0, min(K - k0, KS));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp * kRowsWarp + lane / kRowLanes;  // 0 .. 31
  const int cl = lane % kRowLanes;
  const int col = n0 + cl * kCols;
  const int ncols = N - col;
  const size_t step = (size_t)kRowsStep * N;
  const BT* p = b + (size_t)(k0 + group) * N + col;
  const bool whole = vec && n0 + kTile <= N;  // block-uniform
  // ring slots of whole 16-byte rows; slot st's row u holds row st 128 + u
  // 32 + group at ring[(st % kStages) kSlotSteps + u][thread]
  const int slots = ring_layout && whole ? nk / kSlotRows : 0;
  auto issue = [&](int st) {  // one commit group a slot, empty or not
    if (st < slots) {
      uint4* d = ring + (st % kStages) * kSlotSteps * kThreads + threadIdx.x;
      const BT* src = p + (size_t)st * kSlotSteps * step;
#pragma unroll
      for (int u = 0; u < kSlotSteps; ++u)
        cp_async16(d + u * kThreads, src + u * step);
    }
    cp_async_commit();
  };
  if (slots > 0) {  // block-uniform; out before the staging below
    for (int st = 0; st < kStages - 1; ++st) issue(st);
  }
  stage_table(codes, table, s_tab, M);
  // the split's activation rows: as[kk * MR + m]
  for (int i = threadIdx.x; i < nk * MR; i += kThreads) {
    const int kk = i / MR, m = i % MR;
    as[i] = m < M ? act((size_t)m * K + k0 + kk) : 0.0f;
  }
  __syncthreads();

  float acc[MR][kCols];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.0f;
  if (slots > 0) {
    for (int st = 0; st < slots; ++st) {
      cp_async_wait<kStages - 2>();  // slot st has landed (this lane's rows)
      issue(st + kStages - 1);       // into the slot read one round ago
      const uint4* d =
          ring + (st % kStages) * kSlotSteps * kThreads + threadIdx.x;
#pragma unroll
      for (int u = 0; u < kSlotSteps; ++u) {
        const uint4 q = d[u * kThreads];
        Row8<BT> row;
        row.w[0] = q.x; row.w[1] = q.y; row.w[2] = q.z; row.w[3] = q.w;
        float v[kCols];
        codes.row(row, v);
        kn_fma<MR>(as, st * kSlotRows + u * kRowsStep + group, v, acc);
      }
    }
    cp_async_wait<0>();
  }
  int r0 = slots * kSlotRows;
  p += (size_t)slots * kSlotSteps * step;
  if (whole) {  // block-uniform: whole 16-byte loads
    for (; r0 + kRowsIter <= nk; r0 += kRowsIter, p += kInFlight * step)
      kn_iteration<false, MR>(p, step, as, codes, r0, group, nk, ncols,
                              true, acc);
  }
  for (; r0 < nk; r0 += kRowsIter, p += kInFlight * step)  // block-uniform
    kn_iteration<true, MR>(p, step, as, codes, r0, group, nk, ncols,
                           vec != 0, acc);
  __syncthreads();  // every warp is done with the activation rows

  // red[(group * MR + m) * kTile + c]: each row-lane group's sums, added
  // in group order
  float* red = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float4* d = reinterpret_cast<float4*>(red + (group * MR + m) * kTile +
                                          cl * kCols);
    d[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    d[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  float* dst = S == 1 ? out : partial + (size_t)split * M * N;
  for (int i = threadIdx.x; i < MR * kTile; i += kThreads) {
    const int m = i / kTile, c = i % kTile;
    if (m >= M || n0 + c >= N) continue;
    float sum = red[m * kTile + c];
#pragma unroll 8
    for (int gr = 1; gr < kRowGroups; ++gr)
      sum += red[(gr * MR + m) * kTile + c];
    dst[(size_t)m * N + n0 + c] = sum;
  }
  if (S > 1) finish_tile(partial, out, tickets, n0, M, N, S);
}

// The P values of each lane summed over the warp's 32 lanes by recursive
// halving: at mask 16, 8, ... a lane keeps half of its values (the upper
// half where its mask bit is set) and adds its partner's; once one value
// is left, plain xor steps.  Every slot's sum is the same lane tree
// (lanes paired by bit 4, then 3, ... 0) whatever P: afterwards lane l
// holds slot l / (32 / P) in v[0].
template <int P>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[P], int lane) {
  int width = P;
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1) {
    if (width > 1) {
      const int half = width / 2;
      const bool upper = (lane & mask) != 0;
#pragma unroll
      for (int i = 0; i < P / 2; ++i) {
        if (i < half) {
          const float send = upper ? v[i] : v[i + half];
          const float keep = upper ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
      }
      width = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], mask);
    }
  }
}

// The transpose of [N, K] weights bt (output n's codes at bt[n K ...]):
// one (64-output-row tile, K split of 2048 codes).  Warp w owns the
// split's 256 codes from w 256, lane l 8 of them, whose activations sit
// in its registers for every row; the warp walks the tile's rows 4 at a
// time (a 512-byte warp-load a row), sums each lane's 8 products, and
// adds the 32 lanes' sums of 4 x MR (row, m) slots by a reduce-scatter.
// The 8 warps' sums of a row are added in warp order.
template <int MR, typename Act, typename BT, typename Codes>
__global__ void __launch_bounds__(kThreads) posit_gemv_f_t_kernel(
    Act act, const BT* __restrict__ bt, Codes codes,
    const uint32_t* __restrict__ table, float* __restrict__ out,
    float* __restrict__ partial, int* __restrict__ tickets, int M, int N,
    int K, int KS, int S, int vec) {
  extern __shared__ float4 smem4[];
  __shared__ uint32_t s_tab[Codes::kTableEntries > 0 ? Codes::kTableEntries
                                                     : 1];
  constexpr bool kRing = sizeof(BT) == 2;
  // [the ring (int16 codes): slot i's row g at ring[(i % kStages) kTGroup
  // + g][thread]] [the warps' row sums red[warp][row][m]]
  uint4* ring = reinterpret_cast<uint4*>(smem4);
  float* red = reinterpret_cast<float*>(smem4) + (kRing ? kRingBytes / 4 : 0);
  const int n0 = blockIdx.x * kTile, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = split * KS + warp * kTSpan;  // the warp's chunk
  const int k0 = kw + lane * kCols;
  const int nk = min(K - k0, kCols);
  // warp-uniform: every row of the tile and all 256 codes in range
  const bool whole = vec && n0 + kTile <= N && kw + kTSpan <= K;
  const bool streamed = kRing && whole;
  const BT* p = bt + (size_t)n0 * K + k0;
  auto issue = [&](int gi) {  // rows gi 4 .. gi 4 + 3; one commit group
    if (gi < kTile / kTGroup) {
      uint4* d = ring + (gi % kStages) * kTGroup * kThreads + threadIdx.x;
#pragma unroll
      for (int g = 0; g < kTGroup; ++g)
        cp_async16(d + g * kThreads, p + (size_t)(gi * kTGroup + g) * K);
    }
    cp_async_commit();
  };
  if (streamed) {  // out before the staging below
    for (int gi = 0; gi < kStages - 1; ++gi) issue(gi);
  }
  stage_table(codes, table, s_tab, M);
  float x[MR][kCols];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      x[m][j] = (m < M && j < nk) ? act((size_t)m * K + k0 + j) : 0.0f;
  __syncthreads();  // the table

  constexpr int P = kTGroup * MR;  // (row, m) slots a group
  constexpr int rep = 32 / P;      // lanes holding a slot's sum
  const int slot = lane / rep;
  // rows q0 .. q0 + 3: each lane's 8 products summed, the lanes' sums
  // added (a reduce-scatter), each (row, m) sum into red
  auto rows_sums = [&](const Row8<BT> (&w)[kTGroup], int q0) {
    float acc[P];
#pragma unroll
    for (int g = 0; g < kTGroup; ++g) {
      float v[kCols];
      codes.row(w[g], v);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) a = fmaf(x[m][j], v[j], a);
        acc[g * MR + m] = a;
      }
    }
    warp_reduce_scatter<P>(acc, lane);
    if (lane % rep == 0) red[(warp * kTile + q0) * MR + slot] = acc[0];
  };
  if (streamed) {  // warp-uniform
    for (int q0 = 0; q0 < kTile; q0 += kTGroup) {
      cp_async_wait<kStages - 2>();  // rows q0 .. q0 + 3 have landed
      issue(q0 / kTGroup + kStages - 1);
      const uint4* d = ring + ((q0 / kTGroup) % kStages) * kTGroup *
                                  kThreads + threadIdx.x;
      Row8<BT> w[kTGroup];
#pragma unroll
      for (int g = 0; g < kTGroup; ++g) {
        const uint4 q = d[g * kThreads];
        w[g].w[0] = q.x; w[g].w[1] = q.y; w[g].w[2] = q.z; w[g].w[3] = q.w;
      }
      rows_sums(w, q0);
    }
    cp_async_wait<0>();
  } else if (kw < K) {  // warp-uniform: a chunk past K adds nothing
    for (int q0 = 0; q0 < kTile; q0 += kTGroup) {
      // rows past N and codes past K read as code 1.0 (their x is 0 or
      // their sums are never written)
      Row8<BT> w[kTGroup];
#pragma unroll
      for (int g = 0; g < kTGroup; ++g) {
        const BT* row = p + (size_t)(q0 + g) * K;
        if (whole)
          w[g].load(row, kCols, true);
        else if (n0 + q0 + g < N && nk > 0)
          w[g].load(row, nk, vec != 0);
        else
          fill_ones(w[g]);
      }
      rows_sums(w, q0);
    }
  } else {
    for (int i = lane; i < kTile * MR; i += 32)
      red[warp * kTile * MR + i] = 0.0f;
  }
  __syncthreads();
  float* dst = S == 1 ? out : partial + (size_t)split * M * N;
  for (int i = threadIdx.x; i < kTile * MR; i += kThreads) {
    const int q = i / MR, m = i % MR, n = n0 + q;
    if (m >= M || n >= N) continue;
    float sum = red[q * MR + m];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[(w * kTile + q) * MR + m];
    dst[(size_t)m * N + n] = sum;
  }
  if (S > 1) finish_tile(partial, out, tickets, n0, M, N, S);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > 200 * 1024) return kRefused;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int MR, typename Act, typename BT, typename Codes>
int launch_rows(Act act, const BT* b, Codes codes, const uint32_t* table,
                float* out, float* partial, int* tickets, int M, int N,
                int K, int layout, int KS, int S, cudaStream_t s) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(b) % (kCols * sizeof(BT)) == 0;
  dim3 grid((N + kTile - 1) / kTile, S);
  if (layout == 0) {
    const size_t act_bytes = sizeof(float) * (size_t)KS * MR;
    const size_t red_bytes = sizeof(float) * (size_t)kRowGroups * MR * kTile;
    // the ring (at least as large as red), then the activations
    const size_t smem = sizeof(BT) == 2 && KS >= kRingMinRows
                            ? kRingBytes + act_bytes
                            : (act_bytes > red_bytes ? act_bytes : red_bytes);
    auto kernel = posit_gemv_f_kernel<MR, Act, BT, Codes>;
    const int e = set_smem(kernel, smem);
    if (e != 0) return e;
    const int vec = N % kCols == 0 && aligned;
    kernel<<<grid, kThreads, smem, s>>>(act, b, codes, table, out, partial,
                                        tickets, M, N, K, KS, S, vec);
  } else {
    if (KS != kTSplit) return kRefused;
    const size_t smem = (sizeof(BT) == 2 ? kRingBytes : 0) +
                        sizeof(float) * (size_t)kWarps * kTile * MR;
    auto kernel = posit_gemv_f_t_kernel<MR, Act, BT, Codes>;
    const int e = set_smem(kernel, smem);
    if (e != 0) return e;
    const int vec = K % kCols == 0 && aligned;
    kernel<<<grid, kThreads, smem, s>>>(act, b, codes, table, out, partial,
                                        tickets, M, N, K, KS, S, vec);
  }
  return (int)cudaGetLastError();
}

template <typename Act, typename BT, typename Codes>
int launch(Act act, const void* b, Codes codes, const uint32_t* table,
           float* out, float* partial, int* tickets, int M, int N, int K,
           int layout, int KS, int S, cudaStream_t s) {
  if (S < 1 || KS < 1 || (S > 1 && (partial == nullptr || tickets == nullptr)))
    return kRefused;
  if (Codes::kTableEntries > 0 && table == nullptr) return kRefused;
  const BT* w = static_cast<const BT*>(b);
  if (M <= 1)
    return launch_rows<1>(act, w, codes, table, out, partial, tickets, M, N,
                          K, layout, KS, S, s);
  if (M <= 2)
    return launch_rows<2>(act, w, codes, table, out, partial, tickets, M, N,
                          K, layout, KS, S, s);
  if (M <= 4)
    return launch_rows<4>(act, w, codes, table, out, partial, tickets, M, N,
                          K, layout, KS, S, s);
  if (M <= 8)
    return launch_rows<8>(act, w, codes, table, out, partial, tickets, M, N,
                          K, layout, KS, S, s);
  return kRefused;
}

template <typename Act>
int launch_weights(Act act, const void* b, int b_bytes, int nb, int esb,
                   int variant, const uint32_t* table, float* out,
                   float* partial, int* tickets, int M, int N, int K,
                   int layout, int KS, int S, cudaStream_t s) {
  if (variant == 1) {
    if (b_bytes != 2 || nb != 16 || esb != 2) return kRefused;
    return launch<Act, int16_t>(act, b, DecodeP16_2Table{}, table,
                                out, partial, tickets, M, N, K, layout, KS,
                                S, s);
  }
  if (variant != 0) return kRefused;
  const DecodeEach<DecodeRuntime> dec{{nb, esb}};
  if (b_bytes == 2)
    return launch<Act, int16_t>(act, b, dec, nullptr, out, partial, tickets,
                                M, N, K, layout, KS, S, s);
  if (b_bytes == 1)
    return launch<Act, int8_t>(act, b, dec, nullptr, out, partial, tickets,
                               M, N, K, layout, KS, S, s);
  return kRefused;
}

}  // namespace

// a: [M, K] activations, contiguous, f32 (a_kind 0) or bf16 (a_kind 1).
// b: weight codes in a container of b_bytes (1 = int8, 2 = int16), layout
// 0 a contiguous [K, N], layout 1 a contiguous [N, K] read as its
// transpose.  variant (the wrapper's `gemv_f_variant`): 0 the run-time
// decode of (nb, esb), 1 the P(16,2) table decode (int16 P(16,2) codes;
// table: the 512 (base, step) pairs of posit_matmul.gemv_f_p16_2_table()).
// KS codes of K a split, S splits; when S > 1, partial an [S, M, N] f32
// scratch and tickets one int32 a 64-wide tile, all zero (and left zero).
// out: [M, N] f32.  Returns -1 for a configuration it does not take (the
// wrapper raises ValueError), else a CUDA error code.
extern "C" int posit_gemv_f_launch(const void* a, const void* b, void* out,
                                   void* partial, void* tickets,
                                   const void* table, int M, int N, int K,
                                   int a_kind, int b_bytes, int nb, int esb,
                                   int layout, int variant, int KS, int S,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (layout != 0 && layout != 1) return kRefused;
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  int* t = static_cast<int*>(tickets);
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  if (a_kind == 0)
    return launch_weights(ActF32{static_cast<const float*>(a)}, b, b_bytes,
                          nb, esb, variant, tab, o, p, t, M, N, K, layout,
                          KS, S, s);
  if (a_kind == 1)
    return launch_weights(ActBf16{static_cast<const uint16_t*>(a)}, b,
                          b_bytes, nb, esb, variant, tab, o, p, t, M, N, K,
                          layout, KS, S, s);
  return kRefused;
}
