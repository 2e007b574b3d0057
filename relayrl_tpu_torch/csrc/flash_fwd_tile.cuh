// The flash forward's warp-level tile step on Hopper's tensor cores, shared
// by K1 (flash_fwd.cu, which starts from a fresh state and finalizes) and K4
// (ring_flash.cu, which resumes a carried state and flushes it).
//
// A warp owns 16 query rows. Their prescaled q stays in registers as
// mma.sync m16n8k16 A fragments, and so does their f32 O accumulator (C
// fragments over the head dim). Lane (g = lane / 4, tq = lane % 4) holds
// rows g and g + 8 of the warp. The running max m of each row is the whole
// row's, the same in the 4 lanes of a quad; the running sum l is the lane's
// own share (its columns' p), summed over the quad only at the end, which is
// exact because every lane of a quad rescales by the same factor.
//
// One tile step, on one K/V tile of kTile keys staged in shared memory:
//
//   S = qs . K^T              on the tensor cores, f32 (K rows by ldmatrix)
//   m' = max(m, rowmax S)     reduced over the quad with two shuffles
//   acc *= exp2(m - m'), l *= exp2(m - m')
//   p = exp2(S - m'), l += p  (the unrounded p)
//   acc += round(p) . V       round(p) repacked from the S accumulator as A
//                             fragments in registers; V by ldmatrix.trans
//
// which are the reference kernels' rounding points: q rounded once after the
// prescale (by the caller), scores and state in f32, p rounded to bf16
// before p.V only. Masked scores are -1e30.
//
// Head dim 256. q's A fragments (64 registers) and a full-width O
// accumulator (128) would not fit beside a tile's scores, so there a block
// owns half of O's columns (kOutCols; the grid's third axis picks them):
// it computes S over the whole head dim, reading q's A fragments by
// ldmatrix from its own rows in shared memory (QRows), and accumulates
// round(p).V over its 128 columns alone, with only those columns of each V
// tile staged. Both column blocks of a row compute the same S, so the same
// m and l, bit for bit; the caller lets one of them write the row's lse2
// (K1) or its carried m and l (K4).

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace fwd {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // query rows a block owns, 16 per warp
constexpr int kThreads = 2 * kRows;   // 4 warps
constexpr int kTile = 64;             // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

// O columns a block owns: all of them up to D = 128, half at D = 256 (see
// the note at the top). The grid's third axis has D / kOutCols<D> blocks.
template <int D>
constexpr int kOutCols = D > 128 ? D / 2 : D;

// A warp's 16 rows of prescaled q: A fragments in registers up to D = 128,
// rows in shared memory at D = 256.
template <int D>
constexpr bool kQInSmem = D > 128;
template <int D>
using QRows = std::conditional_t<kQInSmem<D>, tc::SmemRows<D>, tc::RegRows<D>>;

// Shared memory for the block's rows of q (none up to D = 128): it follows
// the kernel's K/V tiles in its dynamic shared memory.
template <int D>
constexpr size_t kQRowsBytes = kQInSmem<D> ? kRows * tc::kStride<D> * sizeof(bf16) : 0;

// Starts this block's 16-byte copies of rows [t0, t0 + kTile) of one
// (batch, head) slice `src` (row stride sT elements), columns [col0,
// col0 + N), into the same columns of dst[kTile][kStride<D>]; rows at or
// past `len` are zero-filled, so no garbage reaches a product.
template <int D, int N = D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long sT, int t0,
                                           int len, int col0 = 0) {
  constexpr int kCopies = kTile * (N / 8);
#pragma unroll
  for (int e = threadIdx.x; e < kCopies; e += kThreads) {
    const int r = e / (N / 8);
    const int c = e - r * (N / 8);
    const bool in = t0 + r < len;
    const bf16* row = src + (in ? (long long)(t0 + r) * sT : 0) + col0;
    tc::cp_async_16(dst + r * tc::kStride<D> + col0 + c * 8, row + c * 8, in);
  }
}

// Loads this warp's rows [w0, w0 + 16) of q (one slice, row stride sT; rows
// at or past `len` zero) as its QRows: A fragments in registers, or rows in
// its 16 rows of `own` (shared memory, kQRowsBytes). kScale: q * scale
// rounded to bf16 (K1's prescale, at the load); else q as it is (K4's q
// arrives prescaled).
template <int D, bool kScale>
__device__ __forceinline__ void load_q(tc::RegRows<D>& q, bf16* /*own*/, const bf16* src,
                                       long long sT, int w0, int len, float scale) {
  tc::load_a_frags<D>(q.f, src, sT, w0, len);
  if constexpr (kScale) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.f[kk][i]));
        q.f[kk][i] = tc::pack_bf16(x.x * scale, x.y * scale);
      }
    }
  }
}

template <int D, bool kScale>
__device__ __forceinline__ void load_q(tc::SmemRows<D>& q, bf16* own, const bf16* src,
                                       long long sT, int w0, int len, float scale) {
  bf16* dst = own + (w0 % kRows) * tc::kStride<D>;
  tc::stage_own_rows<D>(dst, src, sT, w0, len);
  if constexpr (kScale) {
    const int lane = threadIdx.x & 31;
#pragma unroll 4
    for (int e = lane; e < 16 * (D / 2); e += 32) {
      const int r = e / (D / 2);
      auto* pair =
          reinterpret_cast<__nv_bfloat162*>(dst + r * tc::kStride<D>) + (e - r * (D / 2));
      const float2 x = __bfloat1622float2(*pair);
      *pair = __floats2bfloat162_rn(x.x * scale, x.y * scale);
    }
    __syncwarp();
  }
  q.rows = dst;
}

// The flash state of one warp's 16 rows, as this lane holds it.
template <int D>
struct State {
  float acc[kOutCols<D> / 8][4];  // O accumulator: C fragments of the block's n-tiles
  float m[2];                     // running max of rows g, g + 8
  float l[2];                     // this lane's share of their running sums
};

// This lane's share of the full row sums of rows g and g + 8.
template <int D>
__device__ __forceinline__ void quad_sum_l(State<D>& st) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
  }
}

// S of one 16-key chunk: qa . Kc^T, where Kc is 16 rows of a shared-memory
// tile starting at `rows` (n-tile 0 the first 8 keys, n-tile 1 the next 8).
template <int D>
__device__ __forceinline__ void chunk_scores(float (&s0)[4], float (&s1)[4], const QRows<D>& qa,
                                             const bf16* rows) {
  const int lane = threadIdx.x & 31;
  // Matrices (keys 0-7, dims 0-7), (keys 0-7, dims 8-15), (keys 8-15,
  // dims 0-7), (keys 8-15, dims 8-15).
  const int off = ((lane & 7) + ((lane >> 4) << 3)) * tc::kStride<D> + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s0[e] = 0.f;
    s1[e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    qa.frag(a, kk);
    tc::ldmatrix_x4(b, rows + off + kk * 16);
    tc::mma_bf16(s0, a, b[0], b[1]);
    tc::mma_bf16(s1, a, b[2], b[3]);
  }
}

// One K/V tile: keys [k0, k0 + kTile) of the shared-memory tiles kt and vt
// (vt's columns [c0, c0 + kOutCols<D>)) against the warp's rows [w0,
// w0 + 16), whose prescaled q is `qa`.
// kMask: the diagonal or ragged tile, which masks keys at or past `len`
// and, when `causal`, keys above a row's diagonal; a 16-key chunk masked
// for every row of the warp is skipped (its p is exactly 0). Interior
// tiles take the unmasked body.
//
// Callers walk key tile 0 first. Key 0 is live for every row in every
// mode, so after the first tile m is finite for every row: every masked
// p = exp2(-1e30 - m) flushes to exactly 0, and so does the correction
// exp2(m - m') while m is still the initial -1e30.
template <int D, bool kMask>
__device__ __forceinline__ void tile_step(State<D>& st, const QRows<D>& qa, const bf16* kt,
                                          const bf16* vt, int c0, int k0, int w0, int len,
                                          bool causal) {
  constexpr int kChunks = kTile / 16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  bool live[kChunks];
  float s[2 * kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int key0 = k0 + 16 * c;
    live[c] = !kMask || (key0 < len && !(causal && key0 > w0 + 15));
    if (live[c]) {
      chunk_scores<D>(s[2 * c], s[2 * c + 1], qa, kt + 16 * c * tc::kStride<D>);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * c][e] = s[2 * c + 1][e] = kNegInf;
    }
  }
  if (kMask) {
#pragma unroll
    for (int n = 0; n < 2 * kChunks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * tq + (e & 1);
        const int row = w0 + g + 8 * (e >> 1);
        if (key >= len || (causal && key > row)) s[n][e] = kNegInf;
      }
    }
  }
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int n = 0; n < 2 * kChunks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float corr = exp2f(st.m[h] - mx[h]);
    st.m[h] = mx[h];
    st.l[h] *= corr;
#pragma unroll
    for (int n = 0; n < kOutCols<D> / 8; ++n) {
      st.acc[n][2 * h] *= corr;
      st.acc[n][2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!live[c]) continue;
    // round(p) of the chunk's two n-tiles is the A fragment of one 16-key
    // k-step: (row g, keys 0-7), (row g + 8, keys 0-7), (row g, keys
    // 8-15), (row g + 8, keys 8-15).
    uint32_t pa[4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[2 * c + nn][e] - mx[e >> 1]);
        st.l[e >> 1] += p[e];
      }
      pa[2 * nn] = tc::pack_bf16(p[0], p[1]);
      pa[2 * nn + 1] = tc::pack_bf16(p[2], p[3]);
    }
    tc::chunk_accumulate<D, kOutCols<D>>(st.acc, pa, vt + 16 * c * tc::kStride<D> + c0);
  }
}

// Walks the K/V tiles [0, kv_end) of one (batch, head) slice (k and v rows
// at stride sT) in order, double-buffered through `sm`: the next tile's
// copies are in flight while the current one computes. Only the block's O
// columns [c0, c0 + kOutCols<D>) of each V tile are staged. The tiles that
// may hold a masked key for some row of the block (rows [q0, q0 + kRows))
// take the masked body; warps whose rows all lie at or past `len` only help
// stage.
template <int D>
__device__ __forceinline__ void walk_tiles(State<D>& st, const QRows<D>& qa,
                                           tc::KvTiles<D, kTile>& sm, const bf16* kb,
                                           const bf16* vb, long long sT, int c0, int kv_end,
                                           int q0, int w0, int len, bool causal) {
  constexpr int N = kOutCols<D>;
  auto& ks = sm.k;
  auto& vs = sm.v;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  stage_tile<D>(ks[0], kb, sT, 0, len);
  stage_tile<D, N>(vs[0], vb, sT, 0, len, c0);
  tc::cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      // The buffer was last read in iteration j - 1, before its barrier.
      stage_tile<D>(ks[(j + 1) & 1], kb, sT, (j + 1) * kTile, len);
      stage_tile<D, N>(vs[(j + 1) & 1], vb, sT, (j + 1) * kTile, len, c0);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * kTile;
    if (w0 < len) {
      if ((causal && k0 + kTile > q0) || k0 + kTile > len) {
        tile_step<D, true>(st, qa, ks[j & 1], vs[j & 1], c0, k0, w0, len, causal);
      } else {
        tile_step<D, false>(st, qa, ks[j & 1], vs[j & 1], c0, k0, w0, len, causal);
      }
    }
    __syncthreads();
  }
}

}  // namespace fwd
