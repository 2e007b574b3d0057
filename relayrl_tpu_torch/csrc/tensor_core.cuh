// Warp-level tensor-core and asynchronous-copy primitives for sm_80 and
// later (used here for sm_90a), as inline PTX: 16-byte and 4-byte cp.async
// with zero-fill, ldmatrix (plain and transposed), and the bf16 -> f32
// mma.sync m16n8k16; the fragment loads and the transposed product that
// the flash kernels (flash_fwd_tile.cuh, flash_bwd_tile.cuh) share; and the
// launch of a kernel on dynamic shared memory.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32,
// g = lane / 4, tq = lane % 4; each 32-bit register holds two bf16, the
// lower column in the lower half):
//
//   A (16 x 16, row-major): a0 = (row g, cols 2tq, 2tq+1), a1 = (row g+8,
//     same cols), a2 = (row g, cols 2tq+8, 2tq+9), a3 = (row g+8, same);
//   B (16 x 8, k x n):      b0 = (k 2tq, 2tq+1; col g), b1 = (k 2tq+8,
//     2tq+9; col g);
//   C (16 x 8, f32):        c0, c1 = (row g, cols 2tq, 2tq+1), c2, c3 =
//     (row g+8, same cols).
//
// So the C fragments of two adjacent n-tiles, rounded to bf16 and packed
// in pairs, are the A fragment of one 16 x 16 k-step: a product's output
// feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; when !in, the 16
// bytes are zero-filled and nothing is read (src must still be a valid
// address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes from global to shared memory; zero-filled when !in.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i (16 bytes each), and register i receives matrix
// i's (row g, cols 2tq, 2tq+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, each matrix transposed: register i receives matrix i's
// (rows 2tq, 2tq+1; col g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a . b on the tensor cores: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (to nearest even) and packed, lo in the
// lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- tiles of D-wide bf16 rows ------------------------------------------------

// Row stride of a shared-memory tile in elements: D plus 16 bytes, which
// puts the 8 rows an ldmatrix reads in 8 distinct bank groups at D = 16,
// 32, 64, 128 and 256.
template <int D>
constexpr int kStride = D + 8;

// Double-buffered shared-memory tiles of kTile K and V rows (69.6 KB at
// D = 128 and 135.2 KB at D = 256 with kTile = 64, so the kernels take
// them as dynamic shared memory; see launch_kernel).
template <int D, int kTile>
struct KvTiles {
  __nv_bfloat16 k[2][kTile * kStride<D>];
  __nv_bfloat16 v[2][kTile * kStride<D>];
};

// A fragments of 16 rows [r0, r0 + 16) of one slice (row stride sT), over
// the D / 16 k-steps of the head dim; rows at or past T are zero.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16* src, long long sT, int r0,
                                             int T_len) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(src + (long long)r * sT);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      f[kk][half] = r < T_len ? row[kk * 8 + tq] : 0u;
      f[kk][2 + half] = r < T_len ? row[kk * 8 + 4 + tq] : 0u;
    }
  }
}

// acc[16 x N] += a (16 x 16) . B, where B is 16 rows of a shared-memory
// tile of D-wide rows starting at `rows` (k = tile row, n = the N head dims
// from `rows`' column: all D by default), read transposed.
template <int D, int N = D>
__device__ __forceinline__ void chunk_accumulate(float (&acc)[N / 8][4], const uint32_t (&a)[4],
                                                 const __nv_bfloat16* rows) {
  const int lane = threadIdx.x & 31;
  // Matrices (rows 0-7, dims 0-7), (rows 8-15, dims 0-7), (rows 0-7,
  // dims 8-15), (rows 8-15, dims 8-15) of each 16-dim pair of n-tiles.
  const int off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride<D> + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < N / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, rows + off + np * 16);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// A fragment of 16 rows of a shared-memory tile starting at `rows` (row
// stride kStride<D>), k-step kk: matrices (rows 0-7, cols 0-7), (rows 8-15,
// cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15) of its 16 dims,
// the layout load_a_frags gives.
template <int D>
__device__ __forceinline__ void ldmatrix_a_frag(uint32_t (&a)[4], const __nv_bfloat16* rows,
                                                int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, rows + (lane & 15) * kStride<D> + (lane >> 4) * 8 + kk * 16);
}

// A warp's own 16 rows of one operand (q in the forward; qs or do, k or v
// in the backward) as the A operand of its products, k-step by k-step.
// RegRows holds the fragments in registers (load_a_frags fills them).
template <int D>
struct RegRows {
  uint32_t f[D / 16][4];
  __device__ __forceinline__ void frag(uint32_t (&a)[4], int kk) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
  }
};

// SmemRows reads them by ldmatrix from the warp's 16 rows staged in shared
// memory (row stride kStride<D>): for the widest head dims, where the
// fragments of every k-step would not fit in registers beside the
// accumulators.
template <int D>
struct SmemRows {
  const __nv_bfloat16* rows;
  __device__ __forceinline__ void frag(uint32_t (&a)[4], int kk) const {
    ldmatrix_a_frag<D>(a, rows, kk);
  }
};

// Starts this warp's 16-byte copies of rows [w0, w0 + 16) of one (batch,
// head) slice `src` (row stride sT elements) into dst[16][kStride<D>],
// rows at or past `len` zero-filled, and waits for them.
template <int D>
__device__ __forceinline__ void stage_own_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long sT, int w0, int len) {
  constexpr int kCopies = 16 * (D / 8);  // 16-byte copies of the warp's rows
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = lane; e < kCopies; e += 32) {
    const int r = e / (D / 8);
    const int c = e - r * (D / 8);
    const bool in = w0 + r < len;
    const __nv_bfloat16* row = src + (in ? (long long)(w0 + r) * sT : 0);
    cp_async_16(dst + r * kStride<D> + c * 8, row + c * 8, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// -- launch ---------------------------------------------------------------

// Launches kernel<<<grid, threads, bytes, stream>>>(a) on `bytes` of
// dynamic shared memory. A block may take more than 48 KB (up to 227 KB on
// Hopper) only after the kernel's limit is raised, which the head dim 128
// and 256 tiles need; the limit is set before each such launch, for the current
// device. Returns the first error (0 on success), so a refused launch
// raises in the wrapper.
template <typename Args>
inline cudaError_t launch_kernel(void (*kernel)(Args), dim3 grid, int threads, size_t bytes,
                                 cudaStream_t stream, const Args& a) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc
