// The flash backward's warp-level tile steps on Hopper's tensor cores, shared
// by K2 and K3 (flash_bwd.cu, which start from zero and write scaled bf16
// rows) and K5 and K6 (ring_flash.cu, which resume carried f32 accumulators
// and flush them unscaled).
//
// A block of 4 warps owns kRows output rows, 16 per warp, and walks kTile-row
// tiles of the other side, staged in shared memory by double-buffered 16-byte
// cp.async (lse2 and delta by 4-byte copies), rows past `len` zero-filled.
// Products are mma.sync m16n8k16 with bf16 operands and f32 accumulators:
//
//   dq pass (K2, K5): a warp's qs and do rows are A fragments, with lse2 and
//     delta per row. Per 16-key chunk: S = qs.K^T and dP = do.V^T, then
//     p = exp2(S - lse2) and dS = p * (dP - delta) on the accumulator
//     fragments, round(dS) repacked as an A fragment, dQ += round(dS).K
//     (K through a transposing ldmatrix).
//   dk/dv pass (K3, K6): a warp's k and v rows are A fragments. Per 16-query
//     chunk: S^T = K.qs^T and dP^T = V.do^T, p and dS with lse2 and delta
//     read per query from shared memory, dV += round(p^T).do and
//     dK += round(dS^T).qs (do and qs through a transposing ldmatrix).
//
// Those are the reference kernels' rounding points: ds rounded to k's dtype
// before ds.k, p to do's before p^T.do, ds to q's before ds^T.qs; scores, p,
// ds and every accumulator in f32. Under `causal` a key sees the queries at
// or after it (local positions); only the diagonal tile and a ragged last
// tile take the masked body, and the walks' bounds skip what lies wholly
// beyond the diagonal.
//
// Head dim 128. A warp's two sets of own rows as A fragments take 64
// registers there, beside 64 (dq) or 128 (dk and dv) of accumulators: the
// dk/dv pass would need over 255 and spill. So at D >= 128 (OwnRows) each
// warp stages its own rows in shared memory once and reads each k-step's A
// fragment by ldmatrix where a product needs it; at D <= 64 they stay in
// registers, loaded once. That keeps the dq pass within 255 registers at
// D = 128, not the dk/dv pass: with dk and dv over all 128 columns it
// still held 255 and spilled. So at D = 128 a dk/dv block owns half the
// head dim's output columns (kDkvCols; the grid's third axis picks the
// columns): it computes S^T and dP^T over the whole head dim, as before,
// and accumulates dV and dK over its 64 columns alone, at 1.5x the
// products of one block over all 128.
//
// Head dim 256. A full-width f32 accumulator is 128 registers per thread
// (one warp's 16 rows of 256 columns), so every pass splits its output
// columns over the grid's third axis: a dq block owns half of dq's columns
// (kDqCols, 128), a dk/dv block a quarter of dk's and dv's (kDkvCols, 64),
// which keeps the accumulators at the D = 128 kernels' 64 registers. Each
// block still computes S and dP over the whole head dim, from its own rows
// in shared memory and the other side's full tiles, so the dq pass does
// 5/3 and the dk/dv pass 5/2 the products of one block over every column.
// With S and dP's 16 k-steps unrolled, the compiler hoisted their fragment
// loads until K3, K5 and K6 spilled (255 registers); so at D = 256 the
// k-steps run as a loop, kScoreSteps of them unrolled per trip.
// Every tile set is in dynamic shared memory (over 48 KB from D = 128;
// about 203 KB per block at D = 256; tc::launch_kernel).

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace bwd {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;            // output rows a block owns, 16 per warp
constexpr int kTile = 64;            // rows of the other side per tile
constexpr int kThreads = 2 * kRows;  // 4 warps
static_assert(kRows % 16 == 0 && kTile % 16 == 0, "whole 16-row fragments");

template <int D>
constexpr bool kOwnRowsInSmem = D > 64;

// Output columns of dq a dq block owns: all of them up to D = 128, half at
// D = 256; of dk and dv a dk/dv block owns: all of them at D <= 64, half at
// D = 128, a quarter at D = 256 (see the note at the top). The grid's
// third axis has D / cols blocks.
template <int D>
constexpr int kDqCols = D > 128 ? D / 2 : D;
template <int D>
constexpr int kDkvCols = D > 128 ? D / 4 : D > 64 ? D / 2 : D;

// A warp's own 16 rows of one operand (qs or do for the dq pass, k or v
// for the dk/dv pass): tc::RegRows in registers, tc::SmemRows in shared
// memory.
template <int D>
using OwnRows = std::conditional_t<kOwnRowsInSmem<D>, tc::SmemRows<D>, tc::RegRows<D>>;

// k-steps of S and dP unrolled per trip of their loop: all of them up to
// D = 128, 4 of the 16 at D = 256 (see the note at the top).
template <int D>
constexpr int kScoreSteps = D > 128 ? 4 : D / 16;

// Shared memory for the block's own rows of both operands (none at
// D <= 64): it follows the kernel's tiles in its dynamic shared memory.
template <int D>
constexpr size_t kOwnRowsBytes = kOwnRowsInSmem<D> ? 2 * kRows * tc::kStride<D> * sizeof(bf16) : 0;

// Loads the rows [w0, w0 + 16) of one (batch, head) slice (row stride sT)
// that this warp owns, rows at or past `len` zero, as operand `which` (0 or
// 1) of the block's own rows at `own` (shared memory, kOwnRowsBytes).
template <int D>
__device__ __forceinline__ void load_own_rows(tc::RegRows<D>& a, bf16* /*own*/, int /*which*/,
                                              const bf16* src, long long sT, int w0, int len) {
  tc::load_a_frags<D>(a.f, src, sT, w0, len);
}

template <int D>
__device__ __forceinline__ void load_own_rows(tc::SmemRows<D>& a, bf16* own, int which,
                                              const bf16* src, long long sT, int w0, int len) {
  bf16* dst = own + (which * kRows + (w0 % kRows)) * tc::kStride<D>;
  tc::stage_own_rows<D>(dst, src, sT, w0, len);
  a.rows = dst;
}

// Starts the copies of rows [t0, t0 + kTile) of one (batch, head) slice
// `src` (row stride sT elements) into dst[kTile][tc::kStride<D>]; rows at
// or past `len` are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long sT, int t0,
                                           int len) {
  constexpr int kCopies = kTile * (D / 8);  // 16-byte copies per tile
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (kCopies % kThreads != 0 && e >= kCopies) break;
    const int r = e / (D / 8);
    const int c = e - r * (D / 8);
    const bool in = t0 + r < len;
    const bf16* row = src + (in ? (long long)(t0 + r) * sT : 0);
    tc::cp_async_16(dst + r * tc::kStride<D> + c * 8, row + c * 8, in);
  }
}

// S and dP of one 16 x 16 chunk: a_s . Bs^T and a_d . Bd^T, where Bs and Bd
// are 16 rows of two shared-memory tiles starting at `bs` and `bd` (n-tile
// 0 the first 8 rows, n-tile 1 the next 8).
template <int D>
__device__ __forceinline__ void chunk_scores(float (&s)[2][4], float (&dp)[2][4],
                                             const OwnRows<D>& a_s, const OwnRows<D>& a_d,
                                             const bf16* bs, const bf16* bd) {
  const int lane = threadIdx.x & 31;
  // ldmatrix row addresses: matrices (rows 0-7, dims 0-7), (rows 0-7,
  // dims 8-15), (rows 8-15, dims 0-7), (rows 8-15, dims 8-15).
  const int off = ((lane & 7) + ((lane >> 4) << 3)) * tc::kStride<D> + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 0.f;
      dp[n][e] = 0.f;
    }
  }
  auto k_step = [&](int kk) {
    uint32_t a[4], b[4];
    a_s.frag(a, kk);
    tc::ldmatrix_x4(b, bs + off + kk * 16);
    tc::mma_bf16(s[0], a, b[0], b[1]);
    tc::mma_bf16(s[1], a, b[2], b[3]);
    a_d.frag(a, kk);
    tc::ldmatrix_x4(b, bd + off + kk * 16);
    tc::mma_bf16(dp[0], a, b[0], b[1]);
    tc::mma_bf16(dp[1], a, b[2], b[3]);
  };
  if constexpr (kScoreSteps<D> == D / 16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) k_step(kk);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < D / 16; k0 += kScoreSteps<D>) {
#pragma unroll
      for (int kk = k0; kk < k0 + kScoreSteps<D>; ++kk) k_step(kk);
    }
  }
}

// One K/V tile of the dq pass: keys [k0, k0 + kTile) against this warp's
// rows, accumulating dq over the kDqCols<D> columns from c0. kMask: the
// diagonal or ragged tile, which masks keys at or past `len` and, when
// causal, keys above a row's diagonal; warp_last is the warp's last row.
template <int D, bool kMask>
__device__ __forceinline__ void dq_tile(float (&acc)[kDqCols<D> / 8][4], const OwnRows<D>& qa,
                                        const OwnRows<D>& da,
                                        const float (&lse)[2], const float (&delta)[2],
                                        int c0, const bf16* kt, const bf16* vt, int k0, int r0,
                                        int warp_last, int len, bool causal) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) {
    const int key0 = k0 + 16 * c;
    // Keys ascend: past `len`, or above the warp's last row, every later
    // key is masked for all 16 rows.
    if (kMask && (key0 >= len || (causal && key0 > warp_last))) break;
    float s[2][4], dp[2][4];
    chunk_scores<D>(s, dp, qa, da, kt + 16 * c * tc::kStride<D>, vt + 16 * c * tc::kStride<D>);
    uint32_t dsa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;  // row r0 or r0 + 8
        float p = exp2f(s[n][e] - lse[half]);
        if (kMask) {
          const int key = key0 + 8 * n + 2 * tq + (e & 1);
          if (key >= len || (causal && key > r0 + 8 * half)) p = 0.f;
        }
        ds[e] = p * (dp[n][e] - delta[half]);
      }
      dsa[2 * n] = tc::pack_bf16(ds[0], ds[1]);
      dsa[2 * n + 1] = tc::pack_bf16(ds[2], ds[3]);
    }
    tc::chunk_accumulate<D, kDqCols<D>>(acc, dsa, kt + 16 * c * tc::kStride<D> + c0);
  }
}

// The dq pass of one block: walks the K/V tiles [0, kv_end) of one (batch,
// head) slice (k rows at stride kT from kb, v rows at stride vT from vb) in
// order, double-buffered through `sm`, accumulating into acc (dq's columns
// [c0, c0 + kDqCols<D>)). The block owns query rows [q0, q0 + kRows); this
// thread holds rows r0 and r0 + 8.
template <int D>
__device__ __forceinline__ void walk_dq(float (&acc)[kDqCols<D> / 8][4], const OwnRows<D>& qa,
                                        const OwnRows<D>& da, const float (&lse)[2],
                                        const float (&delta)[2], int c0,
                                        tc::KvTiles<D, kTile>& sm,
                                        const bf16* kb, long long kT, const bf16* vb,
                                        long long vT, int kv_end, int q0, int r0, int len,
                                        bool causal) {
  auto& ks = sm.k;
  auto& vs = sm.v;
  const int warp_last = q0 + 16 * (threadIdx.x >> 5) + 15;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  stage_rows<D>(ks[0], kb, kT, 0, len);
  stage_rows<D>(vs[0], vb, vT, 0, len);
  tc::cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      // The buffer was last read in iteration j - 1, before its barrier.
      stage_rows<D>(ks[(j + 1) & 1], kb, kT, (j + 1) * kTile, len);
      stage_rows<D>(vs[(j + 1) & 1], vb, vT, (j + 1) * kTile, len);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * kTile;
    if ((causal && k0 + kTile > q0) || k0 + kTile > len) {
      dq_tile<D, true>(acc, qa, da, lse, delta, c0, ks[j & 1], vs[j & 1], k0, r0, warp_last,
                       len, causal);
    } else {
      dq_tile<D, false>(acc, qa, da, lse, delta, c0, ks[j & 1], vs[j & 1], k0, r0, warp_last,
                        len, causal);
    }
    __syncthreads();
  }
}

// One qs/do tile of the dk/dv pass: queries [t0, t0 + kTile) against this
// warp's keys, accumulating dk and dv over the kDkvCols<D> columns from c0.
// kMask: the diagonal or ragged tile, which masks queries at or past `len`
// and, when causal, queries before a key; warp_first is the warp's first
// key.
template <int D, bool kMask>
__device__ __forceinline__ void dkv_tile(float (&dk)[kDkvCols<D> / 8][4],
                                         float (&dv)[kDkvCols<D> / 8][4],
                                         const OwnRows<D>& ka, const OwnRows<D>& va, int c0,
                                         const bf16* qt,
                                         const bf16* dot, const float* lse_t,
                                         const float* delta_t, int t0, int r0,
                                         int warp_first, int len, bool causal) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) {
    const int qc0 = t0 + 16 * c;
    if (kMask) {
      if (qc0 >= len) break;
      // Every query of the chunk comes before every key of the warp.
      if (causal && qc0 + 15 < warp_first) continue;
    }
    float s[2][4], dp[2][4];
    chunk_scores<D>(s, dp, ka, va, qt + 16 * c * tc::kStride<D>, dot + 16 * c * tc::kStride<D>);
    uint32_t pa[4], dsa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 16 * c + 8 * n + 2 * tq;  // tile-local query of e = 0, 2
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;  // key r0 or r0 + 8
        p[e] = exp2f(s[n][e] - ((e & 1) ? l2.y : l2.x));
        if (kMask) {
          const int query = t0 + col + (e & 1);
          if (query >= len || (causal && query < r0 + 8 * half)) p[e] = 0.f;
        }
        ds[e] = p[e] * (dp[n][e] - ((e & 1) ? dl.y : dl.x));
      }
      pa[2 * n] = tc::pack_bf16(p[0], p[1]);
      pa[2 * n + 1] = tc::pack_bf16(p[2], p[3]);
      dsa[2 * n] = tc::pack_bf16(ds[0], ds[1]);
      dsa[2 * n + 1] = tc::pack_bf16(ds[2], ds[3]);
    }
    tc::chunk_accumulate<D, kDkvCols<D>>(dv, pa, dot + 16 * c * tc::kStride<D> + c0);
    tc::chunk_accumulate<D, kDkvCols<D>>(dk, dsa, qt + 16 * c * tc::kStride<D> + c0);
  }
}

// The shared-memory tiles of the dk/dv pass: two buffers of qs and do rows,
// lse2 and delta.
template <int D>
struct DkvTiles {
  bf16 q[2][kTile * tc::kStride<D>];
  bf16 d[2][kTile * tc::kStride<D>];
  float lse[2][kTile];
  float delta[2][kTile];
};

// The dk/dv pass of one block: walks the qs/do tiles from query t_begin to
// `len` of one (batch, head) slice (qs rows at stride qT from qb, do rows at
// stride dT from db; lse2 and delta contiguous from lse_row and delta_row)
// in order, double-buffered through `sm`, accumulating into dk and dv
// (columns [c0, c0 + kDkvCols<D>)). The block owns keys [k0, k0 + kRows);
// this thread holds keys r0 and r0 + 8.
template <int D>
__device__ __forceinline__ void walk_dkv(float (&dk)[kDkvCols<D> / 8][4],
                                         float (&dv)[kDkvCols<D> / 8][4],
                                         const OwnRows<D>& ka, const OwnRows<D>& va, int c0,
                                         DkvTiles<D>& sm,
                                         const bf16* qb, long long qT, const bf16* db,
                                         long long dT, const float* lse_row,
                                         const float* delta_row, int t_begin, int k0, int r0,
                                         int len, bool causal) {
  // Tile rows of qs and do, and lse2 and delta of queries [t0, t0 + kTile)
  // with one 4-byte copy each.
  auto stage = [&](int buf, int t0) {
    stage_rows<D>(sm.q[buf], qb, qT, t0, len);
    stage_rows<D>(sm.d[buf], db, dT, t0, len);
    for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) {
      const int i = e % kTile;
      const bool in = t0 + i < len;
      const float* src = (e < kTile ? lse_row : delta_row) + (in ? t0 + i : 0);
      tc::cp_async_4(e < kTile ? &sm.lse[buf][i] : &sm.delta[buf][i], src, in);
    }
    tc::cp_async_commit();
  };

  const int warp_first = k0 + 16 * (threadIdx.x >> 5);
  const int n_tiles = (len - t_begin + kTile - 1) / kTile;
  stage(0, t_begin);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      stage((j + 1) & 1, t_begin + (j + 1) * kTile);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = t_begin + j * kTile;
    const int buf = j & 1;
    if ((causal && t0 < k0 + kRows) || t0 + kTile > len) {
      dkv_tile<D, true>(dk, dv, ka, va, c0, sm.q[buf], sm.d[buf], sm.lse[buf], sm.delta[buf],
                        t0, r0, warp_first, len, causal);
    } else {
      dkv_tile<D, false>(dk, dv, ka, va, c0, sm.q[buf], sm.d[buf], sm.lse[buf], sm.delta[buf],
                         t0, r0, warp_first, len, causal);
    }
    __syncthreads();
  }
}

}  // namespace bwd
