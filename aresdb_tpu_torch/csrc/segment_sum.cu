// K2: slot-indexed segment sum, out[s, c] = sum of values[i, c] over the
// rows i with slots[i] == s; slots outside [0, n_slots) are dropped.
//
// Replaces aresdb_tpu/query/pallas_ops.py _make_factored_pallas_kernel
// (factored_segment_sum_pallas), the hi/lo one-hot matmul reduction that
// puts the scatter on the TPU's MXU. On Hopper a scatter is native:
// shared-memory atomics into the cluster histogram of block_hist.cuh.
//
// Bound on this card: the bytes read, n * 4 of slots and 4C a kept row's
// values, at 3.35 TB/s (10 us at n = 2M, C = 3, every row kept). What
// held the first design (a private n_slots x C table per 512-thread block,
// one row in flight per thread, global atomics above ~19k slots) at 18% of
// that: too few loads in flight with one block an SM, and the global
// branch bound by scattered L2 atomics. Now each thread of a 1,024-thread
// block loads K2_QUADS quads of four rows before it adds any: a quad's
// slots as one int4 and, only where this rank takes one of them, its
// 4 x C values as C float4s (a scalar tail, or scalar loads where the
// pointers are not 16-byte aligned); and every table up to 65,536 slots at
// C = 3 stays on chip in block_hist.cuh's cluster histogram, rows reaching
// their rank as slot-range tiles (float adds to a peer's shared memory are
// compare-and-swap loops), flushed with coalesced global atomics. The
// global-atomic kernel is left for tables no cluster holds (C > 8, or
// too many slots x channels), which no caller of the engine reaches
// (it uses C = 3).
#include "block_hist.cuh"

// quads (four rows) a thread loads before it adds any of them
#define K2_QUADS 2

// __launch_bounds__: ptxas keeps a thread within the 64 registers a
// 1,024-thread block allows (C = 8 needs 104 unbounded), spilling where
// it must, so that every C launches at the policy's block size
template <int C>
__global__ void __launch_bounds__(1024)
    segment_sum_cluster(const int* __restrict__ slots,
                        const float* __restrict__ values, long long n,
                        HistLayout L, float* __restrict__ out) {
  extern __shared__ float hist[];
  cluster_hist_zero(hist, L);
  const HistPart pt = hist_part<HIST_SPLIT_TILES>(L);
  const long long tid = pt.part * blockDim.x + threadIdx.x;
  const long long stride = pt.n_parts * blockDim.x;
  const bool vec =
      (((uintptr_t)slots | (uintptr_t)values) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  const int4* s4 = reinterpret_cast<const int4*>(slots);
  const float4* v4 = reinterpret_cast<const float4*>(values);
  for (long long q0 = tid; q0 < n4; q0 += K2_QUADS * stride) {
    int s[K2_QUADS][4];
    bool take[K2_QUADS][4];
    float v[K2_QUADS][4 * C];
#pragma unroll
    for (int u = 0; u < K2_QUADS; ++u) {
      const long long q = q0 + u * stride;
      const int4 w = q < n4 ? s4[q] : make_int4(-1, -1, -1, -1);
      s[u][0] = w.x;
      s[u][1] = w.y;
      s[u][2] = w.z;
      s[u][3] = w.w;
    }
#pragma unroll
    for (int u = 0; u < K2_QUADS; ++u) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        take[u][k] = hist_takes<HIST_SPLIT_TILES>(L, s[u][k]);
        any = any || take[u][k];
      }
      // a quad none of whose slots this rank takes loads no values
      if (!any) continue;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float4 w = v4[(q0 + u * stride) * C + j];
        v[u][4 * j] = w.x;
        v[u][4 * j + 1] = w.y;
        v[u][4 * j + 2] = w.z;
        v[u][4 * j + 3] = w.w;
      }
    }
#pragma unroll
    for (int u = 0; u < K2_QUADS; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (take[u][k])
          cluster_hist_add<HIST_SPLIT_TILES, C>(hist, L, s[u][k],
                                                 v[u] + k * C);
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) {
    const int s = slots[i];
    if (!hist_takes<HIST_SPLIT_TILES>(L, s)) continue;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = values[i * C + c];
    cluster_hist_add<HIST_SPLIT_TILES, C>(hist, L, s, v);
  }
  cluster_hist_flush<C>(hist, L, out, C, 1);
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

// Launch the cluster kernel for C channels; *planned is false, and nothing
// is launched, where no cluster holds the table.
template <int C>
static cudaError_t launch_cluster(const int* slots, const float* values,
                                  long long n, int n_slots, float* out,
                                  int device, cudaStream_t st, bool* planned) {
  HistLaunch h;
  *planned = hist_plan<HIST_SPLIT_TILES>(segment_sum_cluster<C>, device,
                                         n_slots, C, 0, n, 4 * K2_QUADS, &h);
  if (!*planned) return cudaSuccess;
  return hist_launch(segment_sum_cluster<C>, h, st, slots, values, n, h.L,
                     out);
}

// slots: int32 [n]; values: float32 [n, C] row-major; out: float32
// [n_slots, C], zeroed by the caller. Launches on `stream`, allocates
// nothing, returns the launch's cudaError_t.
extern "C" int ares_segment_sum(const void* slots, const void* values,
                                long long n, int C, int n_slots, void* out,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int* s = (const int*)slots;
  const float* v = (const float*)values;
  float* o = (float*)out;
  bool planned = false;
#define K2_CASE(c)                                                   \
  case c:                                                            \
    err = launch_cluster<c>(s, v, n, n_slots, o, device, st, &planned); \
    break;
  switch (C) {
    K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4)
    K2_CASE(5) K2_CASE(6) K2_CASE(7) K2_CASE(8)
    default: break;  // C > 8: the global-atomic kernel
  }
#undef K2_CASE
  if (err != cudaSuccess) return (int)err;
  if (!planned) {
    const int threads = 512;
    const int grid = rows_grid(segment_sum_global, device, threads, 0, n);
    segment_sum_global<<<grid, threads, 0, st>>>(s, v, n, C, n_slots, o);
  }
  return (int)cudaGetLastError();
}
