// K3: direct segment sum, out[s, c] = sum of values[i, c] over the rows i
// with slots[i] == s; slots outside [0, n_slots) are dropped. Every
// channel is an arbitrary float, and a NaN or inf poisons its own slot
// only: rows of one slot are combined by adding them, never by masking.
//
// Replaces aresdb_tpu/query/pallas_ops.py _make_kernel with _chunk_pump
// (dense_segment_sum), the one-hot matmul reduction that puts the scatter
// on the TPU's MXU and streams row chunks through VMEM with
// double-buffered DMA. On Hopper the scatter is native and the hardware's
// own loads keep rows in flight, so neither carries over.
//
// Bound on this card: the bytes moved, n * 4 of slots and 4C a kept row's
// values plus n_slots * C * 4 written, at 3.35 TB/s (about 10 us at n = 2M,
// C = 3). The engine's call (Q5: sum by day of month x status) puts a
// 2M-row batch on 8 of its 128 slots, and a float atomicAdd to shared
// memory is a compare-and-swap loop on sm_90 (block_hist.cuh), so with one
// table a block every warp spins on some 24 bins: the first design (512
// threads, one row a thread and pass, one table a block) took 0.066 ms
// there. What this one does (kernel_ab.py on an H100, PERF.md):
// - rows load as K2's do (segment_sum.cu): 1,024-thread blocks, slots as
//   int4 and values as float4 quads, a scalar tail, scalar loads where
//   the pointers are not 16-byte aligned; where C is a multiple of 4 a
//   row's values load only if the row is kept, so a cluster's ranks read
//   each value once between them;
// - where 32 copies of the table fit a block (n_slots * C <= 1,816 on this
//   card), each warp adds into a copy of its own (dense_segment_sum_warp),
//   so no warp waits on another. A pass whose kept slots vary in at most
//   K3_GROUP_BITS bits across the warp (few distinct slots, as in Q5) adds
//   by groups: the lanes of one slot are found (__match_any_sync), their
//   rows summed in registers by pointer jumping, and the group's lowest
//   lane adds the sum with a plain load, add and store, no atomic at all.
//   Other passes, whose slots spread and seldom collide, add row by row
//   with shared atomics, which then cost less than the grouping;
// - wider tables take one copy a block, updated with shared atomics per
//   row (dense_segment_sum_cluster); more copies and grouping both lost
//   there on spread slots. A table one block cannot hold goes to
//   block_hist.cuh's cluster histogram with slot-range tiles, as K2's does;
// - a slice is channel-major (bin c * per + slot), so that the lanes of a
//   warp, on scattered slots, hit scattered banks: slot-major, C = 8 put
//   8 lanes on each bank (0.18 ms against 0.076 at 8,192 x 8).
// k3_layout decides the cluster and the copies, in one place.
// dense_segment_sum_global (global atomics) is left for tables no cluster
// of 8 blocks holds: C = 8 above 58,112 slots (232,448 opt-in bytes), which
// no engine call reaches (K3 takes up to 8,192 slots, at C = 3).
#include "block_hist.cuh"

// warps of a K3 block, and so the copies of a table that spare every warp
// atomics
#define K3_WARPS (HIST_THREADS / 32)

// K3's layout of an n_slots x C table on a card whose blocks opt in to
// `optin_bytes` of shared memory and whose clusters hold up to
// `max_cluster` blocks: the smallest cluster that holds one copy
// (hist_policy), then one copy a warp where K3_WARPS copies fit a block,
// else one a block. L.G is 0 where no cluster holds the table.
ARES_HD HistLayout k3_layout(int n_slots, int C, long long optin_bytes,
                             int max_cluster) {
  const int G = hist_policy(n_slots, C, 0, optin_bytes, max_cluster);
  HistLayout L = hist_layout(n_slots, C, G > 0 ? G : 1);
  if (G <= 0) {
    L.G = 0;
    return L;
  }
  L.copies = K3_WARPS;
  if (!hist_fits(L, 0, optin_bytes)) L.copies = 1;
  return L;
}

// Whether every warp of a block has its own copy of the table, so that no
// warp contends with another (kernel dense_segment_sum_warp).
ARES_HD bool k3_private(const HistLayout& L) {
  return L.G > 0 && L.copies == K3_WARPS;
}

#ifdef __CUDACC__

#define K3_FULL 0xffffffffu
// a pass whose kept rows' slots vary in at most this many bits across the
// warp (so at most 16 distinct slots) sums each slot's rows in registers;
// others add row by row with shared atomics
#define K3_GROUP_BITS 4

// quads (four rows) a thread loads before it adds any of them: one in the
// warp kernel, where the next pass's loads then overlap more of this
// pass's adds (5% less time on Q5's batch with the L2 cold)
template <int C, bool kWarp>
__host__ __device__ constexpr int k3_quads() {
  return kWarp ? 1 : (C <= 4 ? 2 : 1);
}

// The slot of this rank's slice that slot s falls in, or -1 where s lies
// outside [0, n_slots) or outside this rank's range.
__device__ __forceinline__ int k3_local(const HistLayout& L, int lo, int s) {
  if ((uint32_t)s >= (uint32_t)L.n_slots) return -1;
  const int local = s - lo;
  return (uint32_t)local < (uint32_t)L.per ? local : -1;
}

// Add channels v[0..C) of this lane's row into slot `local` of copy h,
// channel c at h[c * per + local], with shared atomics (local -1: nothing).
template <int C>
__device__ __forceinline__ void k3_add_atomic(float* h, int per, int local,
                                              const float* v) {
  if (local < 0) return;
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(h + c * per + local, v[c]);
}

// As k3_add_atomic, into a copy no other warp touches, called by every
// lane of the warp together: the lanes of one slot are found
// (__match_any_sync) and their rows summed in registers by pointer
// jumping down the group's lanes in lane order; the group's lowest lane
// adds the sum with a plain load, add and store.
template <int C>
__device__ __forceinline__ void k3_add_grouped(float* h, int per, int local,
                                               float* v) {
  const unsigned peers = __match_any_sync(K3_FULL, local);
  const unsigned lane = threadIdx.x & 31;
  // the largest group of kept rows bounds the steps
  const unsigned most =
      __reduce_max_sync(K3_FULL, local >= 0 ? __popc(peers) : 0u);
  // after k steps each lane holds the sum of its own and the next
  // 2^k - 1 peers' rows
  const unsigned above = peers & ~((2u << lane) - 1u);
  int next = above ? __ffs(above) - 1 : 32;
  for (unsigned d = 1; d < most; d <<= 1) {
    const int from = next < 32 ? next : (int)lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float o = __shfl_sync(K3_FULL, v[c], from);
      if (next < 32) v[c] += o;
    }
    const int after = __shfl_sync(K3_FULL, next, from);
    next = next < 32 ? after : 32;
  }
  if (local >= 0 && (peers & ((1u << lane) - 1u)) == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) h[c * per + local] += v[c];
  }
  // the next row's leader may be another lane of this warp
  __syncwarp();
}

// This lane's quad q of rows: its slots, as slots of this rank's slice
// (k3_local), into loc[0..4); none where q >= n4.
__device__ __forceinline__ void k3_quad_slots(const int4* __restrict__ s4,
                                              long long q, long long n4,
                                              const HistLayout& L, int lo,
                                              int* loc) {
  const int4 w = q < n4 ? s4[q] : make_int4(-1, -1, -1, -1);
  loc[0] = k3_local(L, lo, w.x);
  loc[1] = k3_local(L, lo, w.y);
  loc[2] = k3_local(L, lo, w.z);
  loc[3] = k3_local(L, lo, w.w);
}

// The values of quad q into v[0..4C), zeros for the rows this rank does
// not keep where that saves loads.
template <int C>
__device__ __forceinline__ void k3_quad_values(const float4* __restrict__ v4,
                                               long long q, const int* loc,
                                               float* v) {
  if (C % 4 == 0) {
    // a row is C / 4 float4s: only the rows this rank keeps load
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        const float4 w = loc[k] >= 0 ? v4[(4 * q + k) * (C / 4) + j]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        v[k * C + 4 * j] = w.x;
        v[k * C + 4 * j + 1] = w.y;
        v[k * C + 4 * j + 2] = w.z;
        v[k * C + 4 * j + 3] = w.w;
      }
    return;
  }
  // a quad none of whose rows this rank keeps loads no values
  if ((loc[0] & loc[1] & loc[2] & loc[3]) < 0) {
#pragma unroll
    for (int j = 0; j < 4 * C; ++j) v[j] = 0.f;
    return;
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const float4 w = v4[q * C + j];
    v[4 * j] = w.x;
    v[4 * j + 1] = w.y;
    v[4 * j + 2] = w.z;
    v[4 * j + 3] = w.w;
  }
}

// kWarp: h is this warp's own copy (L.copies == K3_WARPS), and a pass
// whose slots spread little adds by groups.
template <int C, bool kWarp>
__device__ __forceinline__ void k3_body(const int* __restrict__ slots,
                                        const float* __restrict__ values,
                                        long long n, const HistLayout& L,
                                        float* __restrict__ out) {
  constexpr int Q = k3_quads<C, kWarp>();
  extern __shared__ float hist[];
  cluster_hist_zero(hist, L);
  const int lane = threadIdx.x & 31;
  float* h = hist + (threadIdx.x >> 5) % L.copies * (L.per * C);
  const int lo = L.G == 1 ? 0 : (int)ares_cluster_rank() * L.per;
  const HistPart pt = hist_part<HIST_SPLIT_TILES>(L);
  // a warp runs every pass with all its lanes (the warp-wide reductions
  // and shuffles), so the loops run on the warp's first row
  const long long base = pt.part * blockDim.x + (threadIdx.x - lane);
  const long long stride = pt.n_parts * blockDim.x;
  const bool vec = (((uintptr_t)slots | (uintptr_t)values) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  const int4* s4 = reinterpret_cast<const int4*>(slots);
  const float4* v4 = reinterpret_cast<const float4*>(values);
  for (long long w0 = base; w0 < n4; w0 += Q * stride) {
    int loc[Q][4];
    float v[Q][4 * C];
#pragma unroll
    for (int u = 0; u < Q; ++u)
      k3_quad_slots(s4, w0 + lane + u * stride, n4, L, lo, loc[u]);
#pragma unroll
    for (int u = 0; u < Q; ++u)
      k3_quad_values<C>(v4, w0 + lane + u * stride, loc[u], v[u]);
    bool grouped = false;
    if (kWarp) {
      // the bits in which the kept rows' slots differ across the warp
      unsigned any = 0, all = K3_FULL;
#pragma unroll
      for (int u = 0; u < Q; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (loc[u][k] >= 0) {
            any |= (unsigned)loc[u][k];
            all &= (unsigned)loc[u][k];
          }
      const unsigned vary =
          __reduce_or_sync(K3_FULL, any) & ~__reduce_and_sync(K3_FULL, all);
      grouped = __popc(vary) <= K3_GROUP_BITS;
    }
#pragma unroll
    for (int u = 0; u < Q; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (grouped)
          k3_add_grouped<C>(h, L.per, loc[u][k], v[u] + k * C);
        else
          k3_add_atomic<C>(h, L.per, loc[u][k], v[u] + k * C);
      }
    // the next pass's plain adds must see this pass's atomics
    if (kWarp) __syncwarp();
  }
  for (long long i = n4 * 4 + base + lane; i < n; i += stride) {
    const int loc = k3_local(L, lo, slots[i]);
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = loc >= 0 ? values[i * C + c] : 0.f;
    k3_add_atomic<C>(h, L.per, loc, v);
  }
  cluster_hist_flush<C, C, true>(hist, L, out, C, 1);
}

// __launch_bounds__: ptxas keeps a thread within the 64 registers a
// 1,024-thread block allows, spilling where it must.
// One copy of the table a warp. Up to C = 3 (the engine's calls) a thread
// is held to 32 registers (38 unbounded, no spills at 32), so that an SM
// holds two blocks where their copies fit (n_slots * C <= 888, as Q5's
// 128 x 3): with inputs out of L2, twice the warps keep twice the loads
// in flight. One block an SM ran 9% behind the first design on 128
// uniform slots there; two match it and take Q5's batch 4% faster.
template <int C>
__global__ void __launch_bounds__(HIST_THREADS, (C <= 3 ? 2 : 1))
    dense_segment_sum_warp(const int* __restrict__ slots,
                           const float* __restrict__ values, long long n,
                           HistLayout L, float* __restrict__ out) {
  k3_body<C, true>(slots, values, n, L, out);
}

// One copy a block (a slice of it a rank), shared atomics.
template <int C>
__global__ void __launch_bounds__(HIST_THREADS)
    dense_segment_sum_cluster(const int* __restrict__ slots,
                              const float* __restrict__ values, long long n,
                              HistLayout L, float* __restrict__ out) {
  k3_body<C, false>(slots, values, n, L, out);
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
static cudaError_t launch(const int* slots, const float* values, long long n,
                          int n_slots, float* out, int device,
                          cudaStream_t st) {
  long long optin = 0;
  int max_cluster = 0;
  hist_device_limits(device, &optin, &max_cluster);
  const HistLayout L = k3_layout(n_slots, C, optin, max_cluster);
  if (L.G == 0) {
    const int threads = 512;
    const int grid =
        rows_grid(dense_segment_sum_global<C>, device, threads, 0, n);
    dense_segment_sum_global<C>
        <<<grid, threads, 0, st>>>(slots, values, n, n_slots, out);
    return cudaGetLastError();
  }
  const bool warp = k3_private(L);
  auto kernel = warp ? &dense_segment_sum_warp<C>
                     : &dense_segment_sum_cluster<C>;
  HistLaunch h;
  if (!hist_size<HIST_SPLIT_TILES>(
          kernel, device, L, 0, optin, n,
          4 * (warp ? k3_quads<C, true>() : k3_quads<C, false>()), &h))
    return cudaErrorInvalidConfiguration;
  const cudaError_t err =
      hist_launch(kernel, h, st, slots, values, n, h.L, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
    case 1: return (int)launch<1>(s, v, n, n_slots, o, device, st);
    case 2: return (int)launch<2>(s, v, n, n_slots, o, device, st);
    case 3: return (int)launch<3>(s, v, n, n_slots, o, device, st);
    case 4: return (int)launch<4>(s, v, n, n_slots, o, device, st);
    case 5: return (int)launch<5>(s, v, n, n_slots, o, device, st);
    case 6: return (int)launch<6>(s, v, n, n_slots, o, device, st);
    case 7: return (int)launch<7>(s, v, n, n_slots, o, device, st);
    case 8: return (int)launch<8>(s, v, n, n_slots, o, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__
