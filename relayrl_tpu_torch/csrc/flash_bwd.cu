// Flash-attention backward for Hopper (sm_90a): the dq pass and the dk/dv
// pass, with a plain C interface that relayrl_tpu_torch/ops/flash.py loads
// through ctypes.
//
// Replaces the Pallas TPU kernels relayrl_tpu/ops/flash.py::_dq_kernel (K2)
// and ::_dkv_kernel (K3), built by _build_bwd and driven by _bwd_pallas. It
// computes the same functions, causal or full, for bf16 or f32 inputs,
// from the forward's log2-space log-sum-exp lse2 and delta = rowsum(do*o)
// (both f32, computed before the launch as the JAX package does), and from
// qs, q prescaled once outside the kernels as the JAX package's _prescale_q
// does:
//
//   qs = q * log2(e)/sqrt(D), rounded back to the input dtype
//   p  = exp2(qs.k - lse2)            masked scores are -1e30, so p = 0
//   dp = do.v
//   ds = p * (dp - delta)
//   K2: dq = (sum_j round(ds).k_j) / sqrt(D)      ds rounded to k's dtype
//   K3: dv = sum_i round(p).do_i                  p rounded to do's dtype
//       dk = (sum_i round(ds).qs_i) / log2(e)     ds rounded to q's dtype
//
// Scores, p, ds and every accumulator are f32; outputs are in the input
// dtype.
//
// Bound on the H100 at the learner slice's shape (B*H = 64, T = 256,
// D = 32, bf16, causal): the dq pass moves about 5.4 MB and does about
// 0.40 GFLOP, the dk/dv pass about 6.4 MB and 0.54 GFLOP, so both are
// memory-bound with floors near 2 us at 3.35 TB/s. At that size a kernel
// is short and its grid small (256 blocks), so what limits it is latency:
// of the loads, of the products, and of the chain s -> p -> ds -> product
// in each tile. The bf16 kernels below measured 6.8 us (dq) and 8.3 us
// (dk/dv) there on an H100 SXM at 700 W, about 4x the byte floor.
//
// bf16 design (the main path). Both passes keep the TPU kernels' split:
// each output row is owned by one block, so neither needs atomics, and
// the output is deterministic. A block of 4 warps owns 64 output rows, 16
// per warp, and walks 64-row tiles of the other side: of 32, 64 and 128
// output rows against tiles of 32 and 64 rows, the shape measured fastest
// at the learner slice's shape (a sweep of kRows and kTile recorded in
// PERF.md; 128 rows leave SMs idle, 32 rows and 32-row tiles add copies
// and barriers).
//
// - Products on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
//   accumulators, with ldmatrix fragments from shared memory. Chosen over
//   wgmma because every product here has a 16-row A operand per warp that
//   is already in registers (q and do, or k and v, loaded once; ds and p
//   produced by the previous product), and at D <= 64 the kernel is far
//   from the compute roof: wgmma's 64-row warpgroup tiles, its shared
//   memory descriptors and its asynchronous waits would buy nothing here.
//   The operand roundings come for free: round(ds) and round(p) are the
//   bf16 A fragments, and the f32 accumulators are the f32 sums.
// - The tile steps and the walks over the other side's tiles live in
//   flash_bwd_tile.cuh, shared with the ring's K5 and K6 (ring_flash.cu):
//   K2 keeps a warp's 16 rows of qs and do as A fragments and computes
//   S, dP, then dQ += round(dS).K per 16-key chunk; K3 keeps a warp's 16
//   key rows of k and v and computes S^T, dP^T, then dV += round(P^T).do
//   and dK += round(dS^T).qs per 16-query chunk. Here only the prologue
//   (zero accumulators) and the epilogue (scaled bf16 rows) are K2's and
//   K3's own. From D = 128 a warp's own rows are read from shared memory
//   per k-step rather than held in registers (bwd::OwnRows), and a K3
//   block owns half of the head dim's dk and dv columns at D = 128 and a
//   quarter at D = 256 (bwd::kDkvCols), a K2 block half of dq's at D = 256
//   (bwd::kDqCols; the grid's z picks the columns), which keep both
//   kernels from spilling.
// - Staging: each tile of K and V (K2) or of qs, do, lse2 and delta (K3)
//   is copied to shared memory in bf16 (f32 for lse2 and delta) with
//   cp.async, 16 bytes a copy, double-buffered: the next tile loads while
//   the current one computes. Rows at or past T are zero-filled. A tile
//   row is padded by 16 bytes, which puts the 8 rows an ldmatrix reads in
//   8 distinct bank groups. q, k and v are read through (batch, time,
//   head) strides; the copies need 16-byte aligned rows, which the
//   wrapper checks (and run() refuses otherwise).
// - Masks only where needed: the causal mask on the diagonal tile and the
//   T mask on a ragged last tile; every other tile takes an unmasked body.
//   On the diagonal tile a warp skips the 16-row chunks that lie wholly
//   beyond its rows' diagonal. Causal tiles are scheduled longest first
//   (the last query tile of K2, the first key tile of K3).
//
// f32 design. No tensor-core product meets the f32 bar of 5e-5 (TF32 keeps
// about three decimal digits), so f32 inputs keep the first port's design:
// one thread per output row (D / 32 from D = 64, each holding every
// D / 32-th head dim, adding their parts of the dot products with
// shuffles), the other side staged in shared memory as f32 (32-row tiles at
// D = 128, 16-row at D = 256, which keeps them within 48 KB of static
// shared memory; 32 output rows a block at D = 256),
// products as scalar FMAs on the CUDA cores. Keys or queries past T and
// above the diagonal are skipped, which equals the TPU kernels' masked
// p = 0.
//
// Both designs take every T >= 1 and head dims 16, 32, 64, 128 and 256; lse2 and
// delta are contiguous [B, H, T]; dq, dk, dv are written as contiguous
// [B, T, H, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_rows.cuh"
#include "flash_bwd_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = bwd::kRows;  // output rows a block owns
constexpr int kTile = bwd::kTile;  // rows of the other side per tile
constexpr float kInvLog2e = 0.6931471805599453f;  // 1 / log2(e)

struct BwdArgs {
  const void* q;  // qs: q prescaled and rounded
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  void* dq;
  void* dk;
  void* dv;
  int H, len;            // heads, sequence length
  long long qB, qT, qH;  // qs element strides
  long long sB, sT, sH;  // k, v element strides
  long long dB, dT, dH;  // do element strides
  float dq_scale;        // 1 / sqrt(D)
  bool causal;
};

// -- bf16: tensor cores ------------------------------------------------------

// Rounds acc * scale of rows r0 (c0, c1) and r0 + 8 (c2, c3) to bf16 and
// stores them to out [B, T, H, D] at (b, h), columns [col0, col0 + N).
template <int D, int N = D>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 8][4], float scale,
                                           bf16* out, int b, int h, int H, int T_len, int r0,
                                           int col0 = 0) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= T_len) continue;
    uint32_t* row =
        reinterpret_cast<uint32_t*>(out + (((long long)b * T_len + r) * H + h) * D + col0);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      row[n * 4 + tq] =
          tc::pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

// Dynamic shared memory of each bf16 kernel: its tiles, then its own rows.
template <int D>
constexpr size_t kDqSmem = sizeof(tc::KvTiles<D, kTile>) + bwd::kOwnRowsBytes<D>;
template <int D>
constexpr size_t kDkvSmem = sizeof(bwd::DkvTiles<D>) + bwd::kOwnRowsBytes<D>;

template <int D>
__global__ void __launch_bounds__(bwd::kThreads) flash_dq_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<tc::KvTiles<D, kTile>*>(smem);
  bf16* own = reinterpret_cast<bf16*>(smem + sizeof(sm));

  const int T_len = a.len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // The last query tile walks the most keys: launch it first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  constexpr int kCols = bwd::kDqCols<D>;
  const int c0 = kCols < D ? blockIdx.z * kCols : 0;  // this block's dq columns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = q0 + 16 * warp + (lane >> 2);  // this thread's rows r0, r0 + 8

  bwd::OwnRows<D> qa, da;
  bwd::load_own_rows<D>(qa, own, 0, static_cast<const bf16*>(a.q) + b * a.qB + h * a.qH, a.qT,
                        q0 + 16 * warp, T_len);
  bwd::load_own_rows<D>(da, own, 1, static_cast<const bf16*>(a.dout) + b * a.dB + h * a.dH,
                        a.dT, q0 + 16 * warp, T_len);
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    lse[half] = r < T_len ? a.lse[(long long)bh * T_len + r] : 0.f;
    delta[half] = r < T_len ? a.delta[(long long)bh * T_len + r] : 0.f;
  }
  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  // A causal block needs keys only up to its last row's diagonal.
  const int kv_end = a.causal ? min(T_len, q0 + kRows) : T_len;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sB + h * a.sH;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sB + h * a.sH;
  bwd::walk_dq<D>(acc, qa, da, lse, delta, c0, sm, kb, a.sT, vb, a.sT, kv_end, q0, r0, T_len,
                  a.causal);
  store_rows<D, kCols>(acc, a.dq_scale, static_cast<bf16*>(a.dq), b, h, a.H, T_len, r0, c0);
}

template <int D>
__global__ void __launch_bounds__(bwd::kThreads) flash_dkv_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<bwd::DkvTiles<D>*>(smem);
  bf16* own = reinterpret_cast<bf16*>(smem + sizeof(sm));

  const int T_len = a.len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // The first key tile walks the most queries: it has blockIdx.y 0.
  const int k0 = blockIdx.y * kRows;
  constexpr int kCols = bwd::kDkvCols<D>;
  const int c0 = blockIdx.z * kCols;  // this block's dk and dv columns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = k0 + 16 * warp + (lane >> 2);  // this thread's keys r0, r0 + 8
  const long long row0 = (long long)bh * T_len;

  bwd::OwnRows<D> ka, va;
  bwd::load_own_rows<D>(ka, own, 0, static_cast<const bf16*>(a.k) + b * a.sB + h * a.sH, a.sT,
                        k0 + 16 * warp, T_len);
  bwd::load_own_rows<D>(va, own, 1, static_cast<const bf16*>(a.v) + b * a.sB + h * a.sH, a.sT,
                        k0 + 16 * warp, T_len);
  float dk[kCols / 8][4], dv[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  }

  // A causal block needs queries only from its first key's diagonal on.
  bwd::walk_dkv<D>(dk, dv, ka, va, c0, sm,
                   static_cast<const bf16*>(a.q) + b * a.qB + h * a.qH, a.qT,
                   static_cast<const bf16*>(a.dout) + b * a.dB + h * a.dH, a.dT, a.lse + row0,
                   a.delta + row0, a.causal ? k0 : 0, k0, r0, T_len, a.causal);
  store_rows<D, kCols>(dk, kInvLog2e, static_cast<bf16*>(a.dk), b, h, a.H, T_len, r0, c0);
  store_rows<D, kCols>(dv, 1.f, static_cast<bf16*>(a.dv), b, h, a.H, T_len, r0, c0);
}

// -- f32: CUDA cores ---------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(f32::kRows<D>* f32::Split<D>::k)
    flash_dq_f32_kernel(const BwdArgs a) {
  constexpr int kRowsF = f32::kRows<D>;
  constexpr int S = f32::Split<D>::k;
  constexpr int DD = f32::Split<D>::dims;
  constexpr int kTileF = f32::kTile<D>;
  __shared__ __align__(16) float ks[kTileF][D];
  __shared__ __align__(16) float vs[kTileF][D];

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const float* __restrict__ dout = static_cast<const float*>(a.dout);
  const int T_len = a.len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.y * kRowsF;
  const int part = threadIdx.x % S;
  const int row = q0 + threadIdx.x / S;
  const bool live = row < T_len;
  const long long base = (long long)b * a.sB + (long long)h * a.sH;

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
    const float* qp = q + (long long)b * a.qB + (long long)h * a.qH + (long long)row * a.qT;
    const float* dp = dout + (long long)b * a.dB + (long long)h * a.dH + (long long)row * a.dT;
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      const int d = i * S + part;
      qr[i] = qp[d];
      dor[i] = dp[d];
    }
    lse = a.lse[(long long)bh * T_len + row];
    delta = a.delta[(long long)bh * T_len + row];
  }

  // A causal block needs keys only up to its last row's diagonal.
  const int kv_end = a.causal ? min(T_len, q0 + kRowsF) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTileF) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTileF * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (t < kv_end) {
        const long long off = base + (long long)t * a.sT + c;
        kv = k[off];
        vv = v[off];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTileF, kv_end - k0);
    for (int jj = 0; jj < n; ++jj) {
      // Keys ascend: from here on every key is above this row's diagonal.
      // No barrier follows inside this loop, so rows may leave it apart.
      if (a.causal && k0 + jj > row) break;
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
    float* out = static_cast<float*>(a.dq) + (((long long)b * T_len + row) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < DD; ++i) out[i * S + part] = acc[i] * a.dq_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(f32::kRows<D>* f32::Split<D>::k)
    flash_dkv_f32_kernel(const BwdArgs a) {
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
  const int T_len = a.len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = blockIdx.y * f32::kRows<D>;
  const int part = threadIdx.x % S;
  const int key = k0 + threadIdx.x / S;
  const bool live = key < T_len;
  const long long base = (long long)b * a.sB + (long long)h * a.sH;
  const long long qbase = (long long)b * a.qB + (long long)h * a.qH;
  const long long dbase = (long long)b * a.dB + (long long)h * a.dH;
  const long long row0 = (long long)bh * T_len;

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
    const long long off = base + (long long)key * a.sT;
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      const int d = i * S + part;
      kr[i] = k[off + d];
      vr[i] = v[off + d];
    }
  }

  // A causal block needs queries only from its first key's diagonal on.
  for (int t0 = a.causal ? k0 : 0; t0 < T_len; t0 += kTileF) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTileF * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = t0 + r;
      float qv = 0.f;
      float dov = 0.f;
      if (t < T_len) {
        qv = q[qbase + (long long)t * a.qT + c];
        dov = dout[dbase + (long long)t * a.dT + c];
      }
      qs[r][c] = qv;
      dos[r][c] = dov;
    }
    for (int r = threadIdx.x; r < kTileF; r += blockDim.x) {
      const bool in = t0 + r < T_len;
      lse_s[r] = in ? a.lse[row0 + t0 + r] : 0.f;
      delta_s[r] = in ? a.delta[row0 + t0 + r] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTileF, T_len - t0);
    for (int ii = 0; ii < n; ++ii) {
      // Queries before this key do not see it.
      if (a.causal && t0 + ii < key) continue;
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
    const long long out = (((long long)b * T_len + key) * a.H + h) * D;
    float* dk = static_cast<float*>(a.dk) + out;
    float* dv = static_cast<float*>(a.dv) + out;
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      dk[i * S + part] = dk_acc[i] * kInvLog2e;
      dv[i * S + part] = dv_acc[i];
    }
  }
}

// -- launch ------------------------------------------------------------------

template <bool kDq, bool kBf16, int D>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  if constexpr (kBf16) {
    // The grid's third axis picks a block's output columns.
    constexpr int kCols = kDq ? bwd::kDqCols<D> : bwd::kDkvCols<D>;
    const dim3 grid(B * a.H, (a.len + kRows - 1) / kRows, D / kCols);
    if constexpr (kDq) {
      return tc::launch_kernel(flash_dq_bf16_kernel<D>, grid, bwd::kThreads, kDqSmem<D>,
                               stream, a);
    } else {
      return tc::launch_kernel(flash_dkv_bf16_kernel<D>, grid, bwd::kThreads, kDkvSmem<D>,
                               stream, a);
    }
  } else {
    constexpr int kRowsF = f32::kRows<D>;
    const dim3 grid(B * a.H, (a.len + kRowsF - 1) / kRowsF);
    if constexpr (kDq) {
      flash_dq_f32_kernel<D><<<grid, kRowsF * f32::Split<D>::k, 0, stream>>>(a);
    } else {
      flash_dkv_f32_kernel<D><<<grid, kRowsF * f32::Split<D>::k, 0, stream>>>(a);
    }
    return cudaGetLastError();
  }
}

template <bool kDq, bool kBf16>
cudaError_t launch_for_dim(int D, const BwdArgs& a, int B, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<kDq, kBf16, 16>(a, B, s);
    case 32:
      return launch<kDq, kBf16, 32>(a, B, s);
    case 64:
      return launch<kDq, kBf16, 64>(a, B, s);
    case 128:
      return launch<kDq, kBf16, 128>(a, B, s);
    case 256:
      return launch<kDq, kBf16, 256>(a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 kernels' 16-byte copies and 4-byte fragment loads need every
// row of qs, k, v and do to start on a 16-byte boundary.
bool rows_aligned(const BwdArgs& a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.dout);
  const long long strides = a.qB | a.qT | a.qH | a.sB | a.sT | a.sH | a.dB | a.dT | a.dH;
  return (ptrs & 15u) == 0 && (strides & 7) == 0;
}

template <bool kDq>
int run(const BwdArgs& a, int B, int D, int is_bf16, void* stream) {
  if (B <= 0 || a.H <= 0 || a.len <= 0 || (a.len + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16 && !rows_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_for_dim<kDq, true>(D, a, B, s)
                                  : launch_for_dim<kDq, false>(D, a, B, s);
  return static_cast<int>(err);
}

}  // namespace

// qs: q prescaled by log2(e)/sqrt(D) and rounded to the input dtype,
// [B, T, H, D] elements at offset b*qB + t*qT + h*qH + d; k, v: the same at
// b*sB + t*sT + h*sH + d (the two share strides); dout: the same at
// b*dB + t*dT + h*dH + d; lse and delta: contiguous [B, H, T] f32; dq (and
// dk, dv): contiguous [B, T, H, D] in the input dtype. bf16 inputs need
// 16-byte aligned pointers and strides that are multiples of 8 elements.
// Each launches on `stream` and returns the cudaError_t of the launch (0 on
// success).
extern "C" int relayrl_flash_bwd_dq(const void* qs, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int B, int H, int T, int D, long long qB,
                                    long long qT, long long qH, long long sB, long long sT,
                                    long long sH, long long dB, long long dT, long long dH,
                                    float dq_scale, int causal, int is_bf16, void* stream) {
  const BwdArgs a{qs, k,  v,  dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr,
                  H,  T,  qB, qT,   qH, sB, sT, sH, dB, dT, dH, dq_scale, causal != 0};
  return run<true>(a, B, D, is_bf16, stream);
}

extern "C" int relayrl_flash_bwd_dkv(const void* qs, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int T, int D,
                                     long long qB, long long qT, long long qH, long long sB,
                                     long long sT, long long sH, long long dB, long long dT,
                                     long long dH, int causal, int is_bf16, void* stream) {
  const BwdArgs a{qs, k,  v,  dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv,
                  H,  T,  qB, qT,   qH, sB, sT, sH, dB, dT, dH, 0.f, causal != 0};
  return run<false>(a, B, D, is_bf16, stream);
}
