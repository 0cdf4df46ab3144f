// Slot histograms for the dense group-by reductions (K1, K2, K3).
//
// A block keeps a private float histogram of n_slots x C bins in dynamic
// shared memory, updated with shared-memory atomicAdd, and flushes its
// non-zero bins into the global result with one global atomicAdd each.
// Where the histogram does not fit a block's shared memory, callers add
// into global memory directly.
#pragma once

#include <cuda_runtime.h>

// Zero n floats of shared memory with the whole block.
__device__ __forceinline__ void hist_zero(float* h, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) h[j] = 0.f;
  __syncthreads();
}

// Bin j = slot * C + channel goes to out[slot * stride_slot +
// channel * stride_ch]. Bins that stayed 0 are skipped.
__device__ __forceinline__ void hist_flush(const float* h, int n_slots, int C,
                                           float* out, long long stride_slot,
                                           long long stride_ch) {
  __syncthreads();
  for (int j = threadIdx.x; j < n_slots * C; j += blockDim.x) {
    float v = h[j];
    if (v != 0.f)
      atomicAdd(out + (long long)(j / C) * stride_slot +
                    (long long)(j % C) * stride_ch,
                v);
  }
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_sum_int(int v) {
  __shared__ int warp_sums[32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)((blockDim.x + 31) / 32); ++w) total += warp_sums[w];
  return total;
}

// Grid size for a grid-stride loop over n rows: every SM filled to the
// occupancy the kernel allows with this much dynamic shared memory, and no
// more blocks than rows need.
template <typename Kernel>
static int rows_grid(Kernel kernel, int device, int threads, size_t smem,
                     long long n) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  long long need = (n + threads - 1) / threads;
  if (grid > need) grid = need;
  return (int)(grid > 0 ? grid : 1);
}

// Whether `bytes` of dynamic shared memory fit one block beside
// `static_bytes` of static shared memory (above 48 KB only after
// cudaFuncSetAttribute, which the launchers call).
static bool shared_hist_fits(int device, size_t bytes, size_t static_bytes) {
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes + static_bytes <= (size_t)optin;
}
