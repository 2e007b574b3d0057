// The CUDA-core row split the f32 kernels share (flash_fwd.cu, flash_bwd.cu,
// ring_flash.cu): one thread per row at D <= 32, D / 32 from D = 64, each
// holding every (D / 32)-th head dim of the row's vectors (so the threads
// of a row read neighbouring shared-memory words) and adding their parts of
// a dot product with shuffles; the rows a block owns; and the tile of the
// other side's rows that two f32 tiles of D columns fit within 48 KB of
// static shared memory.

#pragma once

namespace f32 {

template <int D>
struct Split {
  static constexpr int k = D > 32 ? D / 32 : 1;  // threads per row
  static constexpr int dims = D / k;             // head dims a thread holds
};

// Rows of the other side per f32 tile: two tiles of 16 rows are 32 KB at
// D = 256.
template <int D>
constexpr int kTile = D > 128 ? 16 : D > 64 ? 32 : 64;

// Output rows a block owns: 32 at D = 256 (256 threads, so each may hold
// the 128 floats of a dk/dv row's vectors and accumulators in registers;
// 64 rows would be 512 threads and at most 128 registers a thread).
template <int D>
constexpr int kRows = D > 128 ? 32 : 64;

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

}  // namespace f32
