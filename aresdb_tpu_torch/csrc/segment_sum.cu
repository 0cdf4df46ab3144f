// K2: slot-indexed segment sum, out[s, c] = sum of values[i, c] over the
// rows i with slots[i] == s; slots outside [0, n_slots) are dropped.
//
// Replaces aresdb_tpu/query/pallas_ops.py _make_factored_pallas_kernel
// (factored_segment_sum_pallas), the hi/lo one-hot matmul reduction that
// puts the scatter on the TPU's MXU. On Hopper a scatter is native: one
// thread per row, shared-memory atomics into a block-private histogram
// (block_hist.cuh), flushed with global atomics. The histogram holds
// n_slots x C floats, so it fits a block up to ~19k slots at C = 3; wider
// slot spaces (up to 65,536) add into global memory directly.
//
// Bound on this card: the bytes read, n * (4 + 4C), at 3.35 TB/s (10 us at
// n = 2M, C = 3). The design reads each row once; what it pays above that
// is atomic contention and each block's flush of its histogram.
#include "block_hist.cuh"

__global__ void segment_sum_shared(const int* __restrict__ slots,
                                   const float* __restrict__ values,
                                   long long n, int C, int n_slots,
                                   float* __restrict__ out) {
  extern __shared__ float hist[];
  hist_zero(hist, n_slots * C);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = slots[i];
    if (s < 0 || s >= n_slots) continue;
    for (int c = 0; c < C; ++c) atomicAdd(&hist[s * C + c], values[i * C + c]);
  }
  hist_flush(hist, n_slots, C, out, C, 1);
}

__global__ void segment_sum_global(const int* __restrict__ slots,
                                   const float* __restrict__ values,
                                   long long n, int C, int n_slots,
                                   float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = slots[i];
    if (s < 0 || s >= n_slots) continue;
    for (int c = 0; c < C; ++c)
      atomicAdd(&out[(long long)s * C + c], values[i * C + c]);
  }
}

// slots: int32 [n]; values: float32 [n, C] row-major; out: float32
// [n_slots, C], zeroed by the caller. Launches on `stream`, allocates
// nothing, returns the launch's cudaError_t.
extern "C" int ares_segment_sum(const void* slots, const void* values,
                                long long n, int C, int n_slots, void* out,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 512;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)n_slots * C * sizeof(float);
  if (shared_hist_fits(device, smem, 0)) {
    err = cudaFuncSetAttribute(
        segment_sum_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = rows_grid(segment_sum_shared, device, threads, smem, n);
    segment_sum_shared<<<grid, threads, smem, st>>>(
        (const int*)slots, (const float*)values, n, C, n_slots, (float*)out);
  } else {
    const int grid = rows_grid(segment_sum_global, device, threads, 0, n);
    segment_sum_global<<<grid, threads, 0, st>>>(
        (const int*)slots, (const float*)values, n, C, n_slots, (float*)out);
  }
  return (int)cudaGetLastError();
}
