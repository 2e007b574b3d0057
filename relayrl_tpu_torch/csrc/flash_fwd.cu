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
// softmax runs on exp2; the running (acc, m, l) are f32; p is rounded to
// the input dtype before the PV product; l is clamped at 1e-30; masked
// scores are -1e30; lse2 = m + log2(l); O is acc / l in the input dtype.
//
// Design. The TPU kernel's sequential KV grid axis becomes a loop inside
// the block. One block owns one (batch*head, 64-row query tile) and each
// of its 64 threads owns one query row: its scaled q and its f32
// accumulator stay in registers. The block walks 64-key tiles of K and V
// up to the causal diagonal, staging each tile in shared memory as f32.
// Each thread scores 16 keys at a time (FMA dot products against
// shared-memory reads that all threads of a warp share), moves its running
// max once per 16 keys, and accumulates p*V. Keys past T and above the
// diagonal are masked in the kernel, so every T >= 1 works (the model's
// T = 1 validation step and ragged lengths such as 17 included).
// q, k and v are read through (batch, time, head) element strides: the
// model passes views of its fused qkv projection, so no transpose or copy
// runs before the kernel. O is written as contiguous [B, T, H, D] and lse2
// as contiguous [B, H, T].
//
// Bound on the H100 at the serving slice's shape (B*H = 512, T = 256,
// D = 32, bf16, causal): about 2.2 GFLOP against about 34 MB of q, k, v,
// O and lse2 traffic, so the function is memory-bound with a floor near
// 10 us at 3.35 TB/s. This first kernel does its arithmetic on the CUDA
// cores, not the tensor cores, so its FMA and shared-memory issue rate
// limits it rather than memory; mma/wgmma tiles, TMA staging and
// pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // query rows per block, one per thread
constexpr int kKeys = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax update
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// An f32 value rounded through the input dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int T_len, long long sB,
                     long long sT, long long sH, float q_scale, bool causal) {
  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kRows;
  const int row = q0 + threadIdx.x;
  const bool live = row < T_len;
  const long long base = (long long)b * sB + (long long)h * sH;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (live) {
    const T* qp = q + base + (long long)row * sT;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = round_to<T>(to_float(qp[d]) * q_scale);
  }
  float m = kNegInf;
  float l = 0.f;

  // A causal block needs keys only up to its last row's diagonal.
  const int kv_end = causal ? min(T_len, q0 + kRows) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kKeys * D; e += kRows) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (t < kv_end) {
        const long long off = base + (long long)t * sT + c;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();
    const int n = min(kKeys, kv_end - k0);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int j0 = k0 + c0;
      // Every key from here on is above this row's diagonal. No barrier
      // follows inside this loop, so threads may leave it independently.
      if (causal && j0 > row) break;
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[c0 + jj][d], dot);
        const int j = j0 + jj;
        const bool valid = j < kv_end && (!causal || j <= row);
        s[jj] = valid ? dot : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      // Key j0 is valid for this row, so mx is finite and every masked
      // p = exp2(-1e30 - mx) flushes to exactly 0.
      const float corr = exp2f(m - mx);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - mx);
        l += p;
        const float pv = round_to<T>(p);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pv, vs[c0 + jj][d], acc[d]);
      }
      m = mx;
    }
  }
  if (live) {
    const float lc = fmaxf(l, 1e-30f);
    T* op = o + (((long long)b * T_len + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_float<T>(acc[d] / lc);
    lse[(long long)bh * T_len + row] = m + log2f(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int T_len, long long sB,
                   long long sT, long long sH, float q_scale, bool causal,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (T_len + kRows - 1) / kRows);
  flash_fwd_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, T_len, sB, sT, sH, q_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(int D, const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int H, int T_len,
                           long long sB, long long sT, long long sH,
                           float q_scale, bool causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, T_len, sB, sT, sH, q_scale,
                           causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, T_len, sB, sT, sH, q_scale,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, T_len, sB, sT, sH, q_scale,
                           causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, T, H, D] elements at offset b*sB + t*sT + h*sH + d (the
// three share strides); o: contiguous [B, T, H, D] in the input dtype;
// lse: contiguous [B, H, T] f32. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int relayrl_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int T,
                                 int D, long long sB, long long sT,
                                 long long sH, float q_scale, int causal,
                                 int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (T + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_for_dim<__nv_bfloat16>(D, q, k, v, o, lse, B, H, T, sB,
                                              sT, sH, q_scale, causal != 0, s)
              : launch_for_dim<float>(D, q, k, v, o, lse, B, H, T, sB, sT, sH,
                                      q_scale, causal != 0, s);
  return static_cast<int>(err);
}
