// K3: direct segment sum, out[s, c] = sum of values[i, c] over the rows i
// with slots[i] == s; slots outside [0, n_slots) are dropped. Every
// channel is an arbitrary float.
//
// Replaces aresdb_tpu/query/pallas_ops.py _make_kernel with _chunk_pump
// (dense_segment_sum), the one-hot matmul reduction that puts the scatter
// on the TPU's MXU and streams row chunks through VMEM with
// double-buffered DMA. On Hopper the scatter is native and the hardware's
// own loads keep rows in flight, so neither carries over: one thread per
// row, shared-memory atomics into a block-private histogram
// (block_hist.cuh), flushed with global atomics. The slot space is capped
// at 8,192 (PALLAS_MAX_SLOTS), so at C <= 6 the C x n_slots floats always
// fit one block; wider tables add into global memory directly. The kernel
// is templated on C (1 to 8), so the channel loop unrolls.
//
// Bound on this card: the bytes moved, n * (4 + 4C) + n_slots * C * 4, at
// 3.35 TB/s (about 10 us at n = 2M, C = 3). The design reads each row once;
// what it pays above that is atomic contention and each block's flush.
#include "block_hist.cuh"

template <int C>
__global__ void dense_segment_sum_shared(const int* __restrict__ slots,
                                         const float* __restrict__ values,
                                         long long n, int n_slots,
                                         float* __restrict__ out) {
  extern __shared__ float hist[];
  hist_zero(hist, n_slots * C);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = slots[i];
    if (s < 0 || s >= n_slots) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(&hist[s * C + c], values[i * C + c]);
  }
  hist_flush(hist, n_slots, C, out, C, 1);
}

template <int C>
__global__ void dense_segment_sum_global(const int* __restrict__ slots,
                                         const float* __restrict__ values,
                                         long long n, int n_slots,
                                         float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = slots[i];
    if (s < 0 || s >= n_slots) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      atomicAdd(&out[(long long)s * C + c], values[i * C + c]);
  }
}

template <int C>
static int launch(const int* slots, const float* values, long long n,
                  int n_slots, float* out, int device, cudaStream_t st) {
  const int threads = 512;
  const size_t smem = (size_t)n_slots * C * sizeof(float);
  if (shared_hist_fits(device, smem, 0)) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_segment_sum_shared<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid =
        rows_grid(dense_segment_sum_shared<C>, device, threads, smem, n);
    dense_segment_sum_shared<C>
        <<<grid, threads, smem, st>>>(slots, values, n, n_slots, out);
  } else {
    const int grid =
        rows_grid(dense_segment_sum_global<C>, device, threads, 0, n);
    dense_segment_sum_global<C>
        <<<grid, threads, 0, st>>>(slots, values, n, n_slots, out);
  }
  return (int)cudaGetLastError();
}

// slots: int32 [n]; values: float32 [n, C] row-major, 1 <= C <= 8; out:
// float32 [n_slots, C], zeroed by the caller. Launches on `stream`,
// allocates nothing, returns the launch's cudaError_t.
extern "C" int ares_dense_segment_sum(const void* slots, const void* values,
                                      long long n, int C, int n_slots,
                                      void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* s = (const int*)slots;
  const float* v = (const float*)values;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1>(s, v, n, n_slots, o, device, st);
    case 2: return launch<2>(s, v, n, n_slots, o, device, st);
    case 3: return launch<3>(s, v, n, n_slots, o, device, st);
    case 4: return launch<4>(s, v, n, n_slots, o, device, st);
    case 5: return launch<5>(s, v, n, n_slots, o, device, st);
    case 6: return launch<6>(s, v, n, n_slots, o, device, st);
    case 7: return launch<7>(s, v, n, n_slots, o, device, st);
    case 8: return launch<8>(s, v, n, n_slots, o, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
