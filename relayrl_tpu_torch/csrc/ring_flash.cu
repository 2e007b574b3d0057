// Ring-attention chunk kernels for Hopper (sm_90a): one ring round of the
// flash forward (K4), of the dq pass (K5) and of the dk/dv pass (K6), with
// a plain C interface that relayrl_tpu_torch/parallel/ring_flash.py loads
// through ctypes.
//
// Replaces the Pallas TPU kernels relayrl_tpu/parallel/ring_flash.py::
// _chunk_fwd_kernel (K4), ::_chunk_dq_kernel (K5) and ::_chunk_dkv_kernel
// (K6), built by _build_chunk_calls and driven by _make_ring_flash. Each
// attends the local queries of one sequence shard to one visiting K/V
// chunk of length C under a mode: 1 FULL (every key; a chunk in the past)
// or 2 DIAG (key <= query on local positions; the shard's own chunk). The
// wrapper never launches for SKIP. Math, as in the TPU kernels:
//
//   qs arrives prescaled by log2(e)/sqrt(D) and rounded to the input dtype
//   s  = qs.k                          (log2 space, f32)
//   K4: resume (acc, m, l) from o_in, m_in, l_in; online softmax on exp2;
//       p rounded to v's dtype before p.v; flush acc, m, l unfinalized
//   p  = exp2(s - lse2), dp = do.v, ds = p * (dp - delta)
//   K5: dq_out = dq_in + sum_j round(ds).k_j         ds rounded to k's dtype
//   K6: dv_out = dv_in + sum_i round(p).do_i         p rounded to do's dtype
//       dk_out = dk_in + sum_i round(ds).qs_i        ds rounded to q's dtype
//
// Every carried buffer and output is f32 and unscaled (the ring applies
// 1/sqrt(D) to dq and 1/log2(e) to dk once, at its end). Each kernel reads
// its *_in buffers and writes separate *_out buffers: on a ring whose
// shards share one card the buffer a shard receives is the tensor its
// predecessor wrote, so nothing is updated in place.
//
// Design. The TPU kernels' sequential grid axis (KV for K4 and K5, Q for K6)
// becomes a loop inside the block, and each output row belongs to one
// block, so no kernel needs atomics. Every key loop starts at the chunk's
// key 0, which is live for every row in both modes, so K4's running max is
// finite before a masked score is exponentiated: exp2(-1e30 - m) flushes to
// exactly 0. Keys past C, and above the diagonal under DIAG, are skipped or
// masked, so any C works. q, k, v and do are read through their own
// (batch, time, head) element strides (views of the fused qkv projection,
// cut by chunk); the state is contiguous [B, H, C, D] and [B, H, C].
//
// bf16 (the main path) runs on the tensor cores: each kernel is the tile
// step of its flash counterpart (mma.sync m16n8k16 with ldmatrix fragments,
// tiles of 64 rows by double-buffered 16-byte cp.async into padded rows,
// zero-filled past C) between a prologue that resumes the carried state and
// an epilogue that flushes it. A block of 4 warps owns 64 rows, 16 per warp,
// and each lane loads the carried f32 rows its C fragments hold as float2
// pairs (rows past C start at 0) and stores them back the same way. DIAG is
// the flash kernels' causal on local positions, FULL their non-causal walk;
// only a DIAG tile on the diagonal and a ragged last tile take the masked
// body.
//
// - K4, on K1's tile step (flash_fwd_tile.cuh): a warp's prescaled q as A
//   fragments, its acc as C fragments from o_in, m from m_in, and l from
//   l_in into one lane of each quad (the tile step keeps each lane's share
//   of l and sums the quad at the flush). At the ring's chunk shape
//   (B*H = 64, C = 64) that is 64 blocks for 132 SMs, yet 16 and 32 rows
//   per block (256 and 128 blocks) timed no faster (PERF.md): a launch this
//   short is bound by the latency of one block's chain (the state's loads,
//   S -> p -> PV, the flush), not by the SMs it leaves idle.
// - K5, on K2's (flash_bwd_tile.cuh): a warp's qs and do as A fragments,
//   lse2 and delta per row, dq from dq_in as C fragments; K/V tiles up to
//   min(C, q0 + 64) under DIAG, the last query tile launched first.
// - K6, on K3's: a warp's k and v as A fragments, dk and dv from dk_in and
//   dv_in as C fragments; qs/do/lse2/delta tiles from the block's first key
//   under DIAG, the first key tile launched first.
//
// Head dims 128 and 256 take the same steps: every bf16 kernel's tiles are
// in dynamic shared memory (over 48 KB there; tc::launch_kernel), K5's and
// K6's own rows are read from shared memory per k-step, as K2's and K3's
// are (bwd::OwnRows), and a K6 block owns half (D = 128) or a quarter
// (D = 256) of the head dim's dk and dv columns, as a K3 block does
// (bwd::kDkvCols; the grid's z picks them). At D = 256 a K5 block owns half
// of dq's columns (bwd::kDqCols), and a K4 block half of acc's, as a K1
// block does (fwd::kOutCols), with q read from shared memory. K4's column
// blocks of a row read the same carried m and l and compute the same new
// ones; the first writes them, and into m_out and l_out, so a block never
// overwrites the m_in its twin has still to read.
//
// q, k, v and do rows must start on 16-byte boundaries, which the wrappers
// check (and the C entries refuse otherwise); K4 also needs k and v of one
// stride.
//
// f32 keeps the first port's design (ring_chunk_*_f32_kernel), because no
// tensor-core type meets the f32 bars (2e-5 forward, 5e-5 accumulators):
// one thread per row, D / 32 from D = 64 (each holds every D / 32-th head
// dim; they add their parts of a dot product with shuffles), the other side
// staged in shared memory as f32, products as scalar FMAs on the CUDA
// cores. A block owns 64 rows (32 at D = 256); each row's own vectors and
// accumulators stay in registers while the block walks 64-row tiles of the
// other side (32 at D = 128, 16 at D = 256, within 48 KB of static shared
// memory), up to (K4, K5) or from (K6) the diagonal under DIAG.
//
// Bound on the H100 at the learner's chunk shape (B*H = 64, C = 64,
// D = 32, bf16, FULL): K4 moves about 1.9 MB (the f32 state in and out is
// more than half of it) and does 34 MFLOP, K5 about 2.1 MB and 50 MFLOP,
// K6 about 3.2 MB and 67 MFLOP, so all three are memory-bound with floors
// of 0.6-1 us at 3.35 TB/s. At that size a launch is short and its grid
// small, so latency limits them: the state's loads, one tile's chain of
// products, the flush. Fusing a ring's rounds into one launch is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_rows.cuh"
#include "flash_bwd_tile.cuh"
#include "flash_fwd_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;   // output rows a bf16 block owns (one grid for every bf16 kernel)
constexpr int kTile = 64;   // rows of the other side per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax update (K4)
constexpr float kNegInf = -1e30f;
constexpr int kModeFull = 1;
constexpr int kModeDiag = 2;

// Element strides of one [B, C, H, D] tensor with a contiguous head dim.
struct Strides {
  long long b, t, h;
  __device__ __forceinline__ long long at(int bb, int tt, int hh) const {
    return (long long)bb * b + (long long)tt * t + (long long)hh * h;
  }
};

struct FwdArgs {
  const void* q;  // prescaled
  const void* k;
  const void* v;
  const float* o_in;  // [B, H, C, D]
  const float* m_in;  // [B, H, C]
  const float* l_in;  // [B, H, C]
  float* o_out;
  float* m_out;
  float* l_out;
  int H, C;
  Strides qs, ks, vs;
  bool diag;
};

struct BwdArgs {
  const void* q;  // prescaled
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, C]
  const float* delta;  // [B, H, C]
  const float* a_in;   // K5: dq_in; K6: dk_in   [B, H, C, D]
  const float* b_in;   // K6: dv_in
  float* a_out;        // K5: dq_out; K6: dk_out
  float* b_out;        // K6: dv_out
  int H, C;
  Strides qs, ks, vs, ds;
  bool diag;
};

// load_state_rows: this lane's C fragments of the warp's 16 rows
// [w0, w0 + 16) of one (batch, head) slice of f32 [C, D] state, columns
// [col0, col0 + N) (rows g and g + 8, the float2 pair of cols 8n + 2tq,
// 8n + 2tq + 1 of each n-tile); store_state_rows writes them back. Rows at
// or past C are not read (they start at 0) and not written.
template <int D, int N = D>
__device__ __forceinline__ void load_state_rows(float (&acc)[N / 8][4], const float* src, int w0,
                                                int C, int col0 = 0) {
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w0 + (lane >> 2) + 8 * half;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float2 x = r < C ? *reinterpret_cast<const float2*>(src + (long long)r * D + col0 +
                                                                n * 8 + 2 * tq)
                             : make_float2(0.f, 0.f);
      acc[n][2 * half] = x.x;
      acc[n][2 * half + 1] = x.y;
    }
  }
}

template <int D, int N = D>
__device__ __forceinline__ void store_state_rows(const float (&acc)[N / 8][4], float* dst, int w0,
                                                 int C, int col0 = 0) {
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w0 + (lane >> 2) + 8 * half;
    if (r >= C) continue;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      *reinterpret_cast<float2*>(dst + (long long)r * D + col0 + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// K4 in bf16: K1's tile step between a resume and a flush of the carried
// state (see the note at the top).
template <int D>
__global__ void __launch_bounds__(fwd::kThreads) ring_chunk_fwd_bf16_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<tc::KvTiles<D, fwd::kTile>*>(smem);
  bf16* own = reinterpret_cast<bf16*>(smem + sizeof(sm));

  const int C = a.C;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.y * fwd::kRows;
  constexpr int kCols = fwd::kOutCols<D>;
  const int c0 = kCols < D ? blockIdx.z * kCols : 0;  // this block's acc columns
  // The column blocks of a row read the same m_in and l_in and compute the
  // same m and l; the first writes them. They land in m_out and l_out,
  // never in the buffers read: a twin still to read m_in sees the old m.
  const bool ml_writer = kCols == D || blockIdx.z == 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int w0 = q0 + 16 * warp;

  fwd::QRows<D> qa;
  fwd::load_q<D, false>(qa, own, static_cast<const bf16*>(a.q) + a.qs.at(b, 0, h), a.qs.t, w0,
                        C, 1.f);
  fwd::State<D> st;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w0 + (lane >> 2) + 8 * half;
    const bool live = r < C;
    const long long srow = (long long)bh * C + r;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const float2 o =
          live ? *reinterpret_cast<const float2*>(a.o_in + srow * D + c0 + n * 8 + 2 * tq)
               : make_float2(0.f, 0.f);
      st.acc[n][2 * half] = o.x;
      st.acc[n][2 * half + 1] = o.y;
    }
    st.m[half] = live ? a.m_in[srow] : fwd::kNegInf;
    st.l[half] = live && tq == 0 ? a.l_in[srow] : 0.f;
  }

  // Under DIAG a block needs keys only up to its last row's diagonal.
  const int kv_end = a.diag ? min(C, q0 + fwd::kRows) : C;
  fwd::walk_tiles<D>(st, qa, sm, static_cast<const bf16*>(a.k) + a.ks.at(b, 0, h),
                     static_cast<const bf16*>(a.v) + a.vs.at(b, 0, h), a.ks.t, c0, kv_end, q0,
                     w0, C, a.diag);

  fwd::quad_sum_l<D>(st);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w0 + (lane >> 2) + 8 * half;
    if (r >= C) continue;
    const long long srow = (long long)bh * C + r;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      *reinterpret_cast<float2*>(a.o_out + srow * D + c0 + n * 8 + 2 * tq) =
          make_float2(st.acc[n][2 * half], st.acc[n][2 * half + 1]);
    }
    if (tq == 0 && ml_writer) {
      a.m_out[srow] = st.m[half];
      a.l_out[srow] = st.l[half];
    }
  }
}

// K5 in bf16: K2's walk between a resume and a flush of the carried dq.
template <int D>
__global__ void __launch_bounds__(bwd::kThreads) ring_chunk_dq_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<tc::KvTiles<D, bwd::kTile>*>(smem);
  bf16* own = reinterpret_cast<bf16*>(smem + sizeof(sm));

  const int C = a.C;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // Under DIAG the last query tile walks the most keys: launch it first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bwd::kRows;
  constexpr int kCols = bwd::kDqCols<D>;
  const int c0 = kCols < D ? blockIdx.z * kCols : 0;  // this block's dq columns
  const int w0 = q0 + 16 * (threadIdx.x >> 5);
  const int r0 = w0 + ((threadIdx.x & 31) >> 2);  // this thread's rows r0, r0 + 8
  const long long row0 = (long long)bh * C;

  bwd::OwnRows<D> qa, da;
  bwd::load_own_rows<D>(qa, own, 0, static_cast<const bf16*>(a.q) + a.qs.at(b, 0, h), a.qs.t,
                        w0, C);
  bwd::load_own_rows<D>(da, own, 1, static_cast<const bf16*>(a.dout) + a.ds.at(b, 0, h),
                        a.ds.t, w0, C);
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    lse[half] = r < C ? a.lse[row0 + r] : 0.f;
    delta[half] = r < C ? a.delta[row0 + r] : 0.f;
  }
  float acc[kCols / 8][4];
  load_state_rows<D, kCols>(acc, a.a_in + row0 * D, w0, C, c0);

  // Under DIAG a block needs keys only up to its last row's diagonal.
  const int kv_end = a.diag ? min(C, q0 + bwd::kRows) : C;
  bwd::walk_dq<D>(acc, qa, da, lse, delta, c0, sm,
                  static_cast<const bf16*>(a.k) + a.ks.at(b, 0, h), a.ks.t,
                  static_cast<const bf16*>(a.v) + a.vs.at(b, 0, h), a.vs.t, kv_end, q0, r0, C,
                  a.diag);
  store_state_rows<D, kCols>(acc, a.a_out + row0 * D, w0, C, c0);
}

// K6 in bf16: K3's walk between a resume and a flush of the carried dk, dv.
template <int D>
__global__ void __launch_bounds__(bwd::kThreads) ring_chunk_dkv_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<bwd::DkvTiles<D>*>(smem);
  bf16* own = reinterpret_cast<bf16*>(smem + sizeof(sm));

  const int C = a.C;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // Under DIAG the first key tile walks the most queries: it has blockIdx.y 0.
  const int k0 = blockIdx.y * bwd::kRows;
  constexpr int kCols = bwd::kDkvCols<D>;
  const int c0 = blockIdx.z * kCols;  // this block's dk and dv columns
  const int w0 = k0 + 16 * (threadIdx.x >> 5);
  const int r0 = w0 + ((threadIdx.x & 31) >> 2);  // this thread's keys r0, r0 + 8
  const long long row0 = (long long)bh * C;

  bwd::OwnRows<D> ka, va;
  bwd::load_own_rows<D>(ka, own, 0, static_cast<const bf16*>(a.k) + a.ks.at(b, 0, h), a.ks.t,
                        w0, C);
  bwd::load_own_rows<D>(va, own, 1, static_cast<const bf16*>(a.v) + a.vs.at(b, 0, h), a.vs.t,
                        w0, C);
  float dk[kCols / 8][4], dv[kCols / 8][4];
  load_state_rows<D, kCols>(dk, a.a_in + row0 * D, w0, C, c0);
  load_state_rows<D, kCols>(dv, a.b_in + row0 * D, w0, C, c0);

  // Under DIAG a block needs queries only from its first key's diagonal on.
  bwd::walk_dkv<D>(dk, dv, ka, va, c0, sm, static_cast<const bf16*>(a.q) + a.qs.at(b, 0, h),
                   a.qs.t, static_cast<const bf16*>(a.dout) + a.ds.at(b, 0, h), a.ds.t,
                   a.lse + row0, a.delta + row0, a.diag ? k0 : 0, k0, r0, C, a.diag);
  store_state_rows<D, kCols>(dk, a.a_out + row0 * D, w0, C, c0);
  store_state_rows<D, kCols>(dv, a.b_out + row0 * D, w0, C, c0);
}

// K4, K5 and K6 in f32: the CUDA-core design (see the note at the top).
template <int D>
__global__ void __launch_bounds__(f32::kRows<D>* f32::Split<D>::k)
    ring_chunk_fwd_f32_kernel(const FwdArgs a) {
  constexpr int S = f32::Split<D>::k;
  constexpr int DD = f32::Split<D>::dims;
  constexpr int kTileF = f32::kTile<D>;
  __shared__ __align__(16) float ks[kTileF][D];
  __shared__ __align__(16) float vs[kTileF][D];

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const int C = a.C;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.y * f32::kRows<D>;
  const int part = threadIdx.x % S;
  const int row = q0 + threadIdx.x / S;
  const bool live = row < C;
  const long long srow = (long long)bh * C + row;  // row of the state

  float qr[DD];
  float acc[DD];
  float m = kNegInf;
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    qr[i] = 0.f;
    acc[i] = 0.f;
  }
  if (live) {
    const float* qp = q + a.qs.at(b, row, h);
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      const int d = i * S + part;
      qr[i] = qp[d];
      acc[i] = a.o_in[srow * D + d];
    }
    m = a.m_in[srow];
    l = a.l_in[srow];
  }

  // Under DIAG a block needs keys only up to its last row's diagonal.
  const int kv_end = a.diag ? min(C, q0 + f32::kRows<D>) : C;
  for (int k0 = 0; k0 < kv_end; k0 += kTileF) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTileF * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (t < kv_end) {
        kv = k[a.ks.at(b, t, h) + c];
        vv = v[a.vs.at(b, t, h) + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTileF, kv_end - k0);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int j0 = k0 + c0;
      // Every key from here on is above this row's diagonal. No barrier
      // follows inside this loop, so rows may leave it independently.
      if (a.diag && j0 > row) break;
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DD; ++i) dot = fmaf(qr[i], ks[c0 + jj][i * S + part], dot);
        dot = f32::row_sum<S>(dot);
        const int j = j0 + jj;
        const bool valid = j < kv_end && (!a.diag || j <= row);
        s[jj] = valid ? dot : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      // Key j0 is valid for this row, so mx is finite and every masked
      // p = exp2(-1e30 - mx) flushes to exactly 0; so does corr while m is
      // still the initial -1e30.
      const float corr = exp2f(m - mx);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DD; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - mx);
        l += p;
        #pragma unroll
        for (int i = 0; i < DD; ++i) acc[i] = fmaf(p, vs[c0 + jj][i * S + part], acc[i]);
      }
      m = mx;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DD; ++i) a.o_out[srow * D + i * S + part] = acc[i];
    if (part == 0) {
      a.m_out[srow] = m;
      a.l_out[srow] = l;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(f32::kRows<D>* f32::Split<D>::k)
    ring_chunk_dq_f32_kernel(const BwdArgs a) {
  constexpr int S = f32::Split<D>::k;
  constexpr int DD = f32::Split<D>::dims;
  constexpr int kTileF = f32::kTile<D>;
  __shared__ __align__(16) float ks[kTileF][D];
  __shared__ __align__(16) float vs[kTileF][D];

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const float* __restrict__ dout = static_cast<const float*>(a.dout);
  const int C = a.C;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.y * f32::kRows<D>;
  const int part = threadIdx.x % S;
  const int row = q0 + threadIdx.x / S;
  const bool live = row < C;
  const long long srow = (long long)bh * C + row;

  float qr[DD];
  float dor[DD];
  float acc[DD];
  float lse = 0.f;
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    qr[i] = 0.f;
    dor[i] = 0.f;
    acc[i] = 0.f;
  }
  if (live) {
    const float* qp = q + a.qs.at(b, row, h);
    const float* dp = dout + a.ds.at(b, row, h);
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      const int d = i * S + part;
      qr[i] = qp[d];
      dor[i] = dp[d];
      acc[i] = a.a_in[srow * D + d];
    }
    lse = a.lse[srow];
    delta = a.delta[srow];
  }

  const int kv_end = a.diag ? min(C, q0 + f32::kRows<D>) : C;
  for (int k0 = 0; k0 < kv_end; k0 += kTileF) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTileF * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (t < kv_end) {
        kv = k[a.ks.at(b, t, h) + c];
        vv = v[a.vs.at(b, t, h) + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTileF, kv_end - k0);
    for (int jj = 0; jj < n; ++jj) {
      // Keys ascend: under DIAG every key from here on is above this
      // row's diagonal. No barrier follows inside this loop.
      if (a.diag && k0 + jj > row) break;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < DD; ++i) {
        const int d = i * S + part;
        s = fmaf(qr[i], ks[jj][d], s);
        dp = fmaf(dor[i], vs[jj][d], dp);
      }
      s = f32::row_sum<S>(s);
      dp = f32::row_sum<S>(dp);
      const float ds = exp2f(s - lse) * (dp - delta);
#pragma unroll
      for (int i = 0; i < DD; ++i) acc[i] = fmaf(ds, ks[jj][i * S + part], acc[i]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DD; ++i) a.a_out[srow * D + i * S + part] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(f32::kRows<D>* f32::Split<D>::k)
    ring_chunk_dkv_f32_kernel(const BwdArgs a) {
  constexpr int S = f32::Split<D>::k;
  constexpr int DD = f32::Split<D>::dims;
  constexpr int kTileF = f32::kTile<D>;
  __shared__ __align__(16) float qs[kTileF][D];
  __shared__ __align__(16) float dos[kTileF][D];
  __shared__ float lse_s[kTileF];
  __shared__ float delta_s[kTileF];

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const float* __restrict__ dout = static_cast<const float*>(a.dout);
  const int C = a.C;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = blockIdx.y * f32::kRows<D>;
  const int part = threadIdx.x % S;
  const int key = k0 + threadIdx.x / S;
  const bool live = key < C;
  const long long srow = (long long)bh * C + key;
  const long long row0 = (long long)bh * C;

  float kr[DD];
  float vr[DD];
  float dk_acc[DD];
  float dv_acc[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    kr[i] = 0.f;
    vr[i] = 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  if (live) {
    const float* kp = k + a.ks.at(b, key, h);
    const float* vp = v + a.vs.at(b, key, h);
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      const int d = i * S + part;
      kr[i] = kp[d];
      vr[i] = vp[d];
      dk_acc[i] = a.a_in[srow * D + d];
      dv_acc[i] = a.b_in[srow * D + d];
    }
  }

  // Under DIAG a block needs queries only from its first key's diagonal on.
  for (int t0 = a.diag ? k0 : 0; t0 < C; t0 += kTileF) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTileF * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = t0 + r;
      float qv = 0.f;
      float dov = 0.f;
      if (t < C) {
        qv = q[a.qs.at(b, t, h) + c];
        dov = dout[a.ds.at(b, t, h) + c];
      }
      qs[r][c] = qv;
      dos[r][c] = dov;
    }
    for (int r = threadIdx.x; r < kTileF; r += blockDim.x) {
      const bool in = t0 + r < C;
      lse_s[r] = in ? a.lse[row0 + t0 + r] : 0.f;
      delta_s[r] = in ? a.delta[row0 + t0 + r] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTileF, C - t0);
    for (int ii = 0; ii < n; ++ii) {
      // Under DIAG queries before this key do not see it.
      if (a.diag && t0 + ii < key) continue;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < DD; ++i) {
        const int d = i * S + part;
        s = fmaf(kr[i], qs[ii][d], s);
        dp = fmaf(vr[i], dos[ii][d], dp);
      }
      s = f32::row_sum<S>(s);
      dp = f32::row_sum<S>(dp);
      const float p = exp2f(s - lse_s[ii]);
            const float ds = p * (dp - delta_s[ii]);
#pragma unroll
      for (int i = 0; i < DD; ++i) {
        const int d = i * S + part;
        dv_acc[i] = fmaf(p, dos[ii][d], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[ii][d], dk_acc[i]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      a.a_out[srow * D + i * S + part] = dk_acc[i];
      a.b_out[srow * D + i * S + part] = dv_acc[i];
    }
  }
}

enum class Kernel { kFwd, kDq, kDkv };

template <Kernel K, bool kBf16, int D, typename Args>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static_assert(fwd::kRows == kRows && bwd::kRows == kRows, "one grid for every bf16 kernel");
  if constexpr (kBf16) {
    // The grid's third axis picks a block's output columns.
    constexpr int kCols = K == Kernel::kFwd  ? fwd::kOutCols<D>
                          : K == Kernel::kDq ? bwd::kDqCols<D>
                                             : bwd::kDkvCols<D>;
    const dim3 grid(B * a.H, (a.C + kRows - 1) / kRows, D / kCols);
    if constexpr (K == Kernel::kFwd) {
      return tc::launch_kernel(ring_chunk_fwd_bf16_kernel<D>, grid, fwd::kThreads,
                               sizeof(tc::KvTiles<D, fwd::kTile>) + fwd::kQRowsBytes<D>,
                               stream, a);
    } else if constexpr (K == Kernel::kDq) {
      return tc::launch_kernel(ring_chunk_dq_bf16_kernel<D>, grid, bwd::kThreads,
                               sizeof(tc::KvTiles<D, bwd::kTile>) + bwd::kOwnRowsBytes<D>,
                               stream, a);
    } else {
      return tc::launch_kernel(ring_chunk_dkv_bf16_kernel<D>, grid, bwd::kThreads,
                               sizeof(bwd::DkvTiles<D>) + bwd::kOwnRowsBytes<D>, stream, a);
    }
  } else {
    const dim3 grid(B * a.H, (a.C + f32::kRows<D> - 1) / f32::kRows<D>);
    const int threads = f32::kRows<D> * f32::Split<D>::k;
    if constexpr (K == Kernel::kFwd) {
      ring_chunk_fwd_f32_kernel<D><<<grid, threads, 0, stream>>>(a);
    } else if constexpr (K == Kernel::kDq) {
      ring_chunk_dq_f32_kernel<D><<<grid, threads, 0, stream>>>(a);
    } else {
      ring_chunk_dkv_f32_kernel<D><<<grid, threads, 0, stream>>>(a);
    }
  }
  return cudaGetLastError();
}

template <Kernel K, bool kBf16, typename Args>
cudaError_t launch_for_dim(int D, const Args& a, int B, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<K, kBf16, 16>(a, B, s);
    case 32:
      return launch<K, kBf16, 32>(a, B, s);
    case 64:
      return launch<K, kBf16, 64>(a, B, s);
    case 128:
      return launch<K, kBf16, 128>(a, B, s);
    case 256:
      return launch<K, kBf16, 256>(a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 kernels' 16-byte copies and 4-byte fragment loads need every row
// of q, k, v (and do) to start on a 16-byte boundary; K4's walk also reads
// k and v through one stride.
bool row_aligned(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && ((s.b | s.t | s.h) & 7) == 0;
}

bool rows_aligned(const FwdArgs& a) {
  return row_aligned(a.q, a.qs) && row_aligned(a.k, a.ks) && row_aligned(a.v, a.vs) &&
         a.ks.b == a.vs.b && a.ks.t == a.vs.t && a.ks.h == a.vs.h;
}

bool rows_aligned(const BwdArgs& a) {
  return row_aligned(a.q, a.qs) && row_aligned(a.k, a.ks) && row_aligned(a.v, a.vs) &&
         row_aligned(a.dout, a.ds);
}

// Sets the mode, checks the launch's dimensions (and the bf16 row rule) and
// launches on `stream`.
template <Kernel K, typename Args>
int run(Args a, int B, int D, int mode, int is_bf16, void* stream) {
  if (B <= 0 || a.H <= 0 || a.C <= 0 || (long long)B * a.H > 0x7fffffffLL ||
      (a.C + kRows - 1) / kRows > 65535 || (mode != kModeFull && mode != kModeDiag)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16 && !rows_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  a.diag = mode == kModeDiag;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_for_dim<K, true>(D, a, B, s)
                                  : launch_for_dim<K, false>(D, a, B, s);
  return static_cast<int>(err);
}

}  // namespace

// q (prescaled), k, v, dout: [B, C, H, D] elements at b*sB + t*sT + h*sH + d,
// each with its own strides; the carried state and the outputs: contiguous
// f32, [B, H, C, D] (o, dq, dk, dv) and [B, H, C] (m, l, lse, delta). mode:
// 1 FULL, 2 DIAG. Each launches on `stream` and returns the cudaError_t of
// the launch (0 on success). bf16 q, k, v and dout need 16-byte aligned
// pointers and strides that are multiples of 8 elements, and
// relayrl_ring_chunk_fwd's k and v one stride (cudaErrorMisalignedAddress
// otherwise).
extern "C" int relayrl_ring_chunk_fwd(
    const void* q, const void* k, const void* v, const void* o_in,
    const void* m_in, const void* l_in, void* o_out, void* m_out, void* l_out,
    int B, int H, int C, int D, long long qB, long long qT, long long qH,
    long long kB, long long kT, long long kH, long long vB, long long vT,
    long long vH, int mode, int is_bf16, void* stream) {
  const FwdArgs a{q,
                  k,
                  v,
                  static_cast<const float*>(o_in),
                  static_cast<const float*>(m_in),
                  static_cast<const float*>(l_in),
                  static_cast<float*>(o_out),
                  static_cast<float*>(m_out),
                  static_cast<float*>(l_out),
                  H,
                  C,
                  {qB, qT, qH},
                  {kB, kT, kH},
                  {vB, vT, vH},
                  false};
  return run<Kernel::kFwd>(a, B, D, mode, is_bf16, stream);
}

extern "C" int relayrl_ring_chunk_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* dq_in, void* dq_out, int B,
    int H, int C, int D, long long qB, long long qT, long long qH, long long kB,
    long long kT, long long kH, long long vB, long long vT, long long vH,
    long long dB, long long dT, long long dH, int mode, int is_bf16,
    void* stream) {
  const BwdArgs a{q,
                  k,
                  v,
                  dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const float*>(dq_in),
                  nullptr,
                  static_cast<float*>(dq_out),
                  nullptr,
                  H,
                  C,
                  {qB, qT, qH},
                  {kB, kT, kH},
                  {vB, vT, vH},
                  {dB, dT, dH},
                  false};
  return run<Kernel::kDq>(a, B, D, mode, is_bf16, stream);
}

extern "C" int relayrl_ring_chunk_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* dk_in, const void* dv_in,
    void* dk_out, void* dv_out, int B, int H, int C, int D, long long qB,
    long long qT, long long qH, long long kB, long long kT, long long kH,
    long long vB, long long vT, long long vH, long long dB, long long dT,
    long long dH, int mode, int is_bf16, void* stream) {
  const BwdArgs a{q,
                  k,
                  v,
                  dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const float*>(dk_in),
                  static_cast<const float*>(dv_in),
                  static_cast<float*>(dk_out),
                  static_cast<float*>(dv_out),
                  H,
                  C,
                  {qB, qT, qH},
                  {kB, kT, kH},
                  {vB, vT, vH},
                  {dB, dT, dH},
                  false};
  return run<Kernel::kDkv>(a, B, D, mode, is_bf16, stream);
}
