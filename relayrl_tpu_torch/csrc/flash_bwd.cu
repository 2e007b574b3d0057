// Flash-attention backward for Hopper (sm_90a): the dq pass and the dk/dv
// pass, with a plain C interface that relayrl_tpu_torch/ops/flash.py loads
// through ctypes.
//
// Replaces the Pallas TPU kernels relayrl_tpu/ops/flash.py::_dq_kernel (K2)
// and ::_dkv_kernel (K3), built by _build_bwd and driven by _bwd_pallas. It
// computes the same functions, causal or full, for bf16 or f32 inputs,
// from the forward's log2-space log-sum-exp lse2 and delta = rowsum(do*o)
// (both f32, computed before the launch as the JAX package does):
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
// Design. K1's design, mirrored. The TPU kernels' sequential grid axis
// (KV for dq, Q for dk/dv) becomes a loop inside the block, and the two
// passes keep the TPU's split: each output row is owned by one block, so
// neither pass needs atomics. K2: a block owns one (batch*head, 64-row
// query tile); each row's scaled q, its do, lse2, delta and dq accumulator
// stay in registers while the block walks 64-key tiles of K and V (staged
// in shared memory as f32) up to the causal diagonal. K3: a block owns a
// 64-row key tile; each row's k, v and the dk and dv accumulators stay in
// registers while the block walks 64-row query tiles of scaled q, do, lse2
// and delta from the diagonal to T. For D = 64 two adjacent threads share a
// row, each holding every other head dim, and add their halves of the two
// dot products with one shuffle: four 64-wide f32 vectors per thread would
// not fit K3 in registers. Keys or queries past T and above the diagonal
// are skipped, which equals the TPU kernels' masked p = 0, so every T >= 1
// works. q, k and v are read through (batch, time, head) element strides
// (views of the model's fused qkv projection), do through its own; lse2
// and delta are contiguous [B, H, T]; dq, dk, dv are written as contiguous
// [B, T, H, D].
//
// Bound on the H100 at the learner slice's shape (B*H = 64, T = 256,
// D = 32, bf16, causal): the dq pass moves about 5.4 MB and does about
// 0.40 GFLOP, the dk/dv pass about 6.4 MB and 0.54 GFLOP, so both are
// memory-bound with floors near 2 us at 3.35 TB/s. This first kernel runs
// its products as scalar FMAs on the CUDA cores with operands read from
// shared memory, so issue rate and occupancy limit it rather than memory;
// mma/wgmma tiles, TMA staging and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // output rows a block owns
constexpr int kTile = 64;  // rows of the other side per shared-memory tile
constexpr float kInvLog2e = 0.6931471805599453f;  // 1 / log2(e)

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

// Threads per row: a thread holds at most 32 head dims of each vector.
// Thread `part` of a row holds dims part, part + kSplit, part + 2*kSplit...
// so the threads of a row read neighbouring shared-memory words.
template <int D>
struct Split {
  static constexpr int k = D > 32 ? D / 32 : 1;
  static constexpr int dims = D / k;
};

// Sum of x over the S adjacent lanes that share one row. Only those lanes
// take part, so rows of one warp may leave their loops at different keys.
template <int S>
__device__ __forceinline__ float row_sum(float x) {
  if constexpr (S > 1) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned group = ((1u << S) - 1u) << (lane & ~(unsigned)(S - 1));
#pragma unroll
    for (int off = 1; off < S; off <<= 1) x += __shfl_xor_sync(group, x, off);
  }
  return x;
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  void* dq;
  void* dk;
  void* dv;
  int H, len;  // heads, sequence length
  long long sB, sT, sH;  // q, k, v element strides
  long long dB, dT, dH;  // do element strides
  float q_scale;         // log2(e) / sqrt(D)
  float dq_scale;        // 1 / sqrt(D)
  bool causal;
};

template <typename T, int D>
__global__ void __launch_bounds__(kRows* Split<D>::k)
    flash_dq_kernel(const BwdArgs a) {
  constexpr int S = Split<D>::k;
  constexpr int DD = Split<D>::dims;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  const int T_len = a.len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.y * kRows;
  const int part = threadIdx.x % S;
  const int row = q0 + threadIdx.x / S;
  const bool live = row < T_len;
  const long long base = (long long)b * a.sB + (long long)h * a.sH;
  const long long dbase = (long long)b * a.dB + (long long)h * a.dH;

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
    const T* qp = q + base + (long long)row * a.sT;
    const T* dp = dout + dbase + (long long)row * a.dT;
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      const int d = i * S + part;
      qr[i] = round_to<T>(to_float(qp[d]) * a.q_scale);
      dor[i] = to_float(dp[d]);
    }
    lse = a.lse[(long long)bh * T_len + row];
    delta = a.delta[(long long)bh * T_len + row];
  }

  // A causal block needs keys only up to its last row's diagonal.
  const int kv_end = a.causal ? min(T_len, q0 + kRows) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (t < kv_end) {
        const long long off = base + (long long)t * a.sT + c;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTile, kv_end - k0);
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
      s = row_sum<S>(s);
      dp = row_sum<S>(dp);
      const float ds = round_to<T>(exp2f(s - lse) * (dp - delta));
#pragma unroll
      for (int i = 0; i < DD; ++i) acc[i] = fmaf(ds, ks[jj][i * S + part], acc[i]);
    }
  }
  if (live) {
    T* out = static_cast<T*>(a.dq) + (((long long)b * T_len + row) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < DD; ++i) out[i * S + part] = from_float<T>(acc[i] * a.dq_scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows* Split<D>::k)
    flash_dkv_kernel(const BwdArgs a) {
  constexpr int S = Split<D>::k;
  constexpr int DD = Split<D>::dims;
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  const int T_len = a.len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = blockIdx.y * kRows;
  const int part = threadIdx.x % S;
  const int key = k0 + threadIdx.x / S;
  const bool live = key < T_len;
  const long long base = (long long)b * a.sB + (long long)h * a.sH;
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
      kr[i] = to_float(k[off + d]);
      vr[i] = to_float(v[off + d]);
    }
  }

  // A causal block needs queries only from its first key's diagonal on.
  for (int t0 = a.causal ? k0 : 0; t0 < T_len; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int t = t0 + r;
      float qv = 0.f;
      float dov = 0.f;
      if (t < T_len) {
        qv = round_to<T>(to_float(q[base + (long long)t * a.sT + c]) * a.q_scale);
        dov = to_float(dout[dbase + (long long)t * a.dT + c]);
      }
      qs[r][c] = qv;
      dos[r][c] = dov;
    }
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      const bool in = t0 + r < T_len;
      lse_s[r] = in ? a.lse[row0 + t0 + r] : 0.f;
      delta_s[r] = in ? a.delta[row0 + t0 + r] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kTile, T_len - t0);
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
      s = row_sum<S>(s);
      dp = row_sum<S>(dp);
      const float p = exp2f(s - lse_s[ii]);
      const float pr = round_to<T>(p);
      const float ds = round_to<T>(p * (dp - delta_s[ii]));
#pragma unroll
      for (int i = 0; i < DD; ++i) {
        const int d = i * S + part;
        dv_acc[i] = fmaf(pr, dos[ii][d], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[ii][d], dk_acc[i]);
      }
    }
  }
  if (live) {
    const long long out = (((long long)b * T_len + key) * a.H + h) * D;
    T* dk = static_cast<T*>(a.dk) + out;
    T* dv = static_cast<T*>(a.dv) + out;
#pragma unroll
    for (int i = 0; i < DD; ++i) {
      dk[i * S + part] = from_float<T>(dk_acc[i] * kInvLog2e);
      dv[i * S + part] = from_float<T>(dv_acc[i]);
    }
  }
}

template <bool kDq, typename T, int D>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.len + kRows - 1) / kRows);
  const int threads = kRows * Split<D>::k;
  if constexpr (kDq) {
    flash_dq_kernel<T, D><<<grid, threads, 0, stream>>>(a);
  } else {
    flash_dkv_kernel<T, D><<<grid, threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t launch_for_dim(int D, const BwdArgs& a, int B, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<kDq, T, 16>(a, B, s);
    case 32:
      return launch<kDq, T, 32>(a, B, s);
    case 64:
      return launch<kDq, T, 64>(a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int run(const BwdArgs& a, int B, int D, int is_bf16, void* stream) {
  if (B <= 0 || a.H <= 0 || a.len <= 0 || (a.len + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
                              ? launch_for_dim<kDq, __nv_bfloat16>(D, a, B, s)
                              : launch_for_dim<kDq, float>(D, a, B, s);
  return static_cast<int>(err);
}

}  // namespace

// q, k, v: [B, T, H, D] elements at offset b*sB + t*sT + h*sH + d (the
// three share strides); dout: the same at b*dB + t*dT + h*dH + d; lse and
// delta: contiguous [B, H, T] f32; dq (and dk, dv): contiguous
// [B, T, H, D] in the input dtype. Each launches on `stream` and returns
// the cudaError_t of the launch (0 on success).
extern "C" int relayrl_flash_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int H, int T, int D,
                                    long long sB, long long sT, long long sH,
                                    long long dB, long long dT, long long dH,
                                    float q_scale, float dq_scale, int causal,
                                    int is_bf16, void* stream) {
  const BwdArgs a{q,  k,  v,  dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr,
                  H,  T,  sB, sT,   sH, dB, dT, dH, q_scale, dq_scale,
                  causal != 0};
  return run<true>(a, B, D, is_bf16, stream);
}

extern "C" int relayrl_flash_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int T,
                                     int D, long long sB, long long sT,
                                     long long sH, long long dB, long long dT,
                                     long long dH, float q_scale, int causal,
                                     int is_bf16, void* stream) {
  const BwdArgs a{q,  k,  v,  dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv,
                  H,  T,  sB, sT,   sH, dB, dT, dH, q_scale, 0.f,
                  causal != 0};
  return run<false>(a, B, D, is_bf16, stream);
}
