// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that relayrl_tpu_torch/ops/flash.py loads through ctypes.
//
// Replaces the Pallas TPU kernel relayrl_tpu/ops/flash.py::_fwd_kernel
// (built by _build_fwd, driven by _fwd). It computes the same function:
// the attention output O and the log2-space log-sum-exp lse2, causal or
// full, for bf16 or f32 inputs.
//
// Math, as in the TPU kernel: q is scaled by log2(e)/sqrt(D) and rounded
// back to the input dtype, so scores come out in log2 space and the online
// softmax runs on exp2; the running (acc, m, l) are f32; l sums the
// unrounded p; p is rounded to the input dtype before the PV product; l is
// clamped at 1e-30; masked scores are -1e30; lse2 = m + log2(l); O is
// acc / l in the input dtype.
//
// Bound on the H100 at the serving slice's shape (B*H = 512, T = 256,
// D = 32, bf16, causal): about 1.1 GFLOP on the live (query, key) pairs
// against about 34 MB of q, k, v, O and lse2, so the function is
// memory-bound with a floor near 10 us at 3.35 TB/s; at the learner's
// shape (B*H = 64) the floor is near 1.3 us and a launch has few blocks,
// so latency (of the loads and of the chain S -> p -> PV in each tile)
// limits it.
//
// bf16 design (the main path), the forward half of flash_bwd.cu's:
//
// - A block of 4 warps owns one (batch*head, 64-row query tile), 16 rows
//   per warp: of 16, 32, 64 and 128 rows per block, timed at both
//   main-path shapes (PERF.md), 64 was the fastest (fewer rows re-stage
//   the same K/V tiles for fewer queries; 128 leave SMs idle behind the
//   longest causal blocks).
// - Each warp loads its 16 rows of q, scales them by log2(e)/sqrt(D) and
//   rounds them to bf16 at the load, into registers as mma.sync m16n8k16
//   A fragments; its O accumulator stays in registers too. The tile step
//   (flash_fwd_tile.cuh, shared with the ring's K4) runs S = qs.K^T and
//   O += round(P).V on the tensor cores, with round(P) repacked from the S
//   accumulator in registers and the row max and sum reduced over a quad
//   with shuffles. mma.sync rather than wgmma: a warp's A operand is
//   already in registers, and at D <= 64 the kernel is far from the
//   compute roof.
// - K/V tiles of 64 keys arrive by 16-byte cp.async, double-buffered into
//   rows padded by 16 bytes (no ldmatrix bank conflicts), zero-filled past
//   T, in dynamic shared memory: 69.6 KB at D = 128, above the 48 KB a
//   block gets without asking (tc::launch_kernel raises the limit). At
//   D = 128 a warp holds 32 registers of q and 64 of O beside the 32 of a
//   tile's scores, which still fits without a spill. q, k and v are read
//   through (batch, time, head) strides, views of the fused qkv
//   projection; rows must start on 16-byte boundaries, which the wrapper
//   checks (and relayrl_flash_fwd refuses otherwise).
// - At D = 256 q's fragments and O over all 256 columns would need about
//   190 registers beside the scores, so a block owns half of O's columns
//   (the grid's third axis picks them; fwd::kOutCols): it recomputes S over
//   the whole head dim with q read by ldmatrix from its rows in shared
//   memory (scaled and rounded there once), and stages only its columns
//   of each V tile; 1.5x the products of one block over every column, in
//   169 KB of shared memory. The two column blocks of a row compute the
//   same m and l; the first writes lse2.
// - Only the diagonal tile and a ragged last tile take the masked body; the
//   tiles walk from key 0, so the running max is finite before a masked
//   score is exponentiated. Causal query tiles are launched longest first.
//
// O is written as contiguous [B, T, H, D] and lse2 as contiguous [B, H, T].
//
// f32 design. No tensor-core type meets the f32 bar of 2e-5 (TF32 keeps
// about three decimal digits), so f32 inputs keep the first port's design:
// q and the accumulator of each query row in registers (one thread per row
// at D <= 32, D / 32 from D = 64, f32_rows.cuh), K and V staged in shared
// memory as f32 (32-key tiles at D = 128 and 16-key tiles at D = 256,
// within 48 KB of static shared memory; 32 rows a block at D = 256),
// scores and p.V as scalar FMAs on the CUDA cores, the running max moved
// once per 16 keys.
//
// Both designs take every T >= 1 and head dims 16, 32, 64, 128 and 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_rows.cuh"
#include "flash_fwd_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fwd::kNegInf;
using fwd::kRows;
using fwd::kTile;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // [B, T, H, D]
  float* lse;        // [B, H, T]
  int H, len;        // heads, sequence length
  long long sB, sT, sH;  // q, k, v element strides
  float q_scale;     // log2(e) / sqrt(D)
  bool causal;
};

// -- bf16: tensor cores ------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(fwd::kThreads) flash_fwd_bf16_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<tc::KvTiles<D, kTile>*>(smem);
  bf16* own = reinterpret_cast<bf16*>(smem + sizeof(sm));

  const int len = a.len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  // The last query tile walks the most keys: launch it first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  constexpr int kCols = fwd::kOutCols<D>;
  const int c0 = kCols < D ? blockIdx.z * kCols : 0;  // this block's O columns
  // The column blocks of a row compute the same lse2: the first writes it.
  const bool lse_writer = kCols == D || blockIdx.z == 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w0 = q0 + 16 * warp;
  const long long base = (long long)b * a.sB + (long long)h * a.sH;

  fwd::QRows<D> qa;
  fwd::load_q<D, true>(qa, own, static_cast<const bf16*>(a.q) + base, a.sT, w0, len,
                       a.q_scale);
  fwd::State<D> st;
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
  }
  st.m[0] = st.m[1] = kNegInf;
  st.l[0] = st.l[1] = 0.f;

  // A causal block needs keys only up to its last row's diagonal.
  const int kv_end = a.causal ? min(len, q0 + kRows) : len;
  fwd::walk_tiles<D>(st, qa, sm, static_cast<const bf16*>(a.k) + base,
                     static_cast<const bf16*>(a.v) + base, a.sT, c0, kv_end, q0, w0, len,
                     a.causal);

  fwd::quad_sum_l<D>(st);
  const int tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w0 + (lane >> 2) + 8 * half;
    if (r >= len) continue;
    const float lc = fmaxf(st.l[half], 1e-30f);
    uint32_t* row = reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.o) +
                                                (((long long)b * len + r) * a.H + h) * D + c0);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      row[n * 4 + tq] = tc::pack_bf16(st.acc[n][2 * half] / lc, st.acc[n][2 * half + 1] / lc);
    }
    if (tq == 0 && lse_writer) a.lse[(long long)bh * len + r] = st.m[half] + log2f(lc);
  }
}

// -- f32: CUDA cores ---------------------------------------------------------

constexpr int kChunkF32 = 16;  // keys per online-softmax update

// A block owns f32::kRows<D> query rows, f32::Split<D>::k threads per row.
template <int D>
__global__ void __launch_bounds__(f32::kRows<D>* f32::Split<D>::k)
    flash_fwd_f32_kernel(const FwdArgs a) {
  constexpr int kRowsF = f32::kRows<D>;
  constexpr int S = f32::Split<D>::k;
  constexpr int DD = f32::Split<D>::dims;
  constexpr int kTileF = f32::kTile<D>;
  __shared__ __align__(16) float ks[kTileF][D];
  __shared__ __align__(16) float vs[kTileF][D];

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
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
  float acc[DD];
#pragma unroll
  for (int i = 0; i < DD; ++i) {
    qr[i] = 0.f;
    acc[i] = 0.f;
  }
  if (live) {
    const float* qp = q + base + (long long)row * a.sT;
#pragma unroll
    for (int i = 0; i < DD; ++i) qr[i] = qp[i * S + part] * a.q_scale;
  }
  float m = kNegInf;
  float l = 0.f;

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
    for (int c0 = 0; c0 < n; c0 += kChunkF32) {
      const int j0 = k0 + c0;
      // Every key from here on is above this row's diagonal. No barrier
      // follows inside this loop, so rows may leave it independently.
      if (a.causal && j0 > row) break;
      float s[kChunkF32];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kChunkF32; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DD; ++i) dot = fmaf(qr[i], ks[c0 + jj][i * S + part], dot);
        dot = f32::row_sum<S>(dot);
        const int j = j0 + jj;
        const bool valid = j < kv_end && (!a.causal || j <= row);
        s[jj] = valid ? dot : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      // Key j0 is valid for this row, so mx is finite and every masked
      // p = exp2(-1e30 - mx) flushes to exactly 0.
      const float corr = exp2f(m - mx);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DD; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunkF32; ++jj) {
        const float p = exp2f(s[jj] - mx);
        l += p;
#pragma unroll
        for (int i = 0; i < DD; ++i) acc[i] = fmaf(p, vs[c0 + jj][i * S + part], acc[i]);
      }
      m = mx;
    }
  }
  if (live) {
    const float lc = fmaxf(l, 1e-30f);
    float* op = static_cast<float*>(a.o) + (((long long)b * T_len + row) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < DD; ++i) op[i * S + part] = acc[i] / lc;
    if (part == 0) a.lse[(long long)bh * T_len + row] = m + log2f(lc);
  }
}

// -- launch ------------------------------------------------------------------

template <bool kBf16, int D>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  if constexpr (kBf16) {
    // The grid's third axis picks a block's O columns.
    const dim3 grid(B * a.H, (a.len + kRows - 1) / kRows, D / fwd::kOutCols<D>);
    return tc::launch_kernel(flash_fwd_bf16_kernel<D>, grid, fwd::kThreads,
                             sizeof(tc::KvTiles<D, kTile>) + fwd::kQRowsBytes<D>, stream, a);
  } else {
    constexpr int kRowsF = f32::kRows<D>;
    const dim3 grid(B * a.H, (a.len + kRowsF - 1) / kRowsF);
    flash_fwd_f32_kernel<D><<<grid, kRowsF * f32::Split<D>::k, 0, stream>>>(a);
    return cudaGetLastError();
  }
}

template <bool kBf16>
cudaError_t launch_for_dim(int D, const FwdArgs& a, int B, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<kBf16, 16>(a, B, s);
    case 32:
      return launch<kBf16, 32>(a, B, s);
    case 64:
      return launch<kBf16, 64>(a, B, s);
    case 128:
      return launch<kBf16, 128>(a, B, s);
    case 256:
      return launch<kBf16, 256>(a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, T, H, D] elements at offset b*sB + t*sT + h*sH + d (the
// three share strides); o: contiguous [B, T, H, D] in the input dtype;
// lse: contiguous [B, H, T] f32. bf16 inputs need 16-byte aligned pointers
// and strides that are multiples of 8 elements. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
extern "C" int relayrl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int H, int T, int D, long long sB,
                                 long long sT, long long sH, float q_scale, int causal,
                                 int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (T + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (is_bf16 && ((ptrs & 15u) != 0 || ((sB | sT | sH) & 7) != 0)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), H, T, sB, sT, sH, q_scale, causal != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_for_dim<true>(D, a, B, s)
                                  : launch_for_dim<false>(D, a, B, s);
  return static_cast<int>(err);
}
