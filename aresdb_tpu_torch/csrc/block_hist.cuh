// Slot histograms for the dense group-by reductions (K1, K2, K3).
//
// All three reduce through the cluster histogram below. A thread-block
// cluster of G blocks splits one n_slots x C table by slot range: rank r
// owns slots [r * per, (r + 1) * per), per = ceil(n_slots / G), in its own
// dynamic shared memory. Tables up to 65,536 slots x 3 channels (786 KB)
// thus stay on chip in a cluster of at most 8 blocks, the portable size.
// Each kernel fixes at compile time how a row reaches the rank that owns
// its slot:
// - HIST_SPLIT_TILES (K2, K3): every rank of a cluster reads the cluster's
//   rows and adds only the ones whose slot it owns, with a local
//   shared-memory add; a row's slot is read G times, all but once from L2.
// - HIST_SPLIT_DSMEM (K1): the ranks read disjoint rows and add each into
//   the owner's shared memory through the cluster's distributed shared
//   memory (ares_cluster_map, cooperative_groups' map_shared_rank),
//   remote for (G - 1) / G.
// At G = 1 both are one private table per block. A block may hold several
// copies of its slice (K3: one a warp where 32 fit, so that no warp
// contends with another); the flush sums them. The grid is
// persistent (cudaOccupancyMaxActiveClusters clusters), each looping over
// rows. After a cluster barrier, which also keeps every block alive while
// peers may still write into its shared memory, each rank adds its own
// range's non-zero bins into the zeroed result with coalesced global
// atomics.
//
// What the measurements chose (kernel_ab.py on an H100, PERF.md): on
// sm_90 a float atomicAdd to shared memory compiles to a compare-and-swap
// loop (ATOMS.CAST.SPIN), and one to another block's shared memory,
// through a generic pointer or PTX red.shared::cluster.add.f32 alike, to a
// generic compare-and-swap loop across the cluster; integer adds are
// native in both. So with float channels only (K2) remote adds ran 3-6x
// slower than tiles, and with K1's integer counts they ran faster than
// tiles, which evaluate every row G times. A private table per block
// (G = 1) beat every cluster size wherever one block holds the table.
// Flushing each cluster's table into a scratch buffer and summing the
// copies in a second kernel lost to the atomic flush at every shape.
//
// The layout arithmetic (ranks, copies, bytes per block, whether a table
// fits, the cluster size) is ARES_HD code, which a host compiler also
// builds: the CPU tests build it with g++ and check it against the card's
// limits given as arguments.
#pragma once

#include "ares_common.cuh"

// every slot index the kernels take is below 2^16 (dense.DENSE_MAX_SLOTS)
#define HIST_MAX_SLOTS 65536

struct HistLayout {
  int n_slots;     // slots of the whole table
  int C;           // channels per slot
  int G;           // ranks (blocks) of a cluster
  int per;         // slots each rank owns: max(ceil(n_slots / G), 2)
  uint32_t magic;  // ceil(2^32 / per): hist_owner's division by per
  int copies;      // copies of the slice each block holds (1 but in K3)
};

ARES_HD HistLayout hist_layout(int n_slots, int C, int G) {
  HistLayout L;
  L.n_slots = n_slots;
  L.C = C;
  L.G = G;
  const int per = (n_slots + G - 1) / G;
  // per >= 2 keeps magic within 32 bits; ranks past the table own nothing
  L.per = per < 2 ? 2 : per;
  L.magic = (uint32_t)((0x100000000ULL + (uint64_t)L.per - 1) / L.per);
  L.copies = 1;
  return L;
}

// The rank that owns slot s, 0 <= s < HIST_MAX_SLOTS: floor(s / per) by a
// multiply-high, exact for s < 2^16 and 2 <= per <= 2^16.
ARES_HD int hist_owner(const HistLayout& L, int s) {
  return (int)(((uint64_t)(uint32_t)s * L.magic) >> 32);
}

// Bytes of dynamic shared memory each block of a cluster holds.
ARES_HD long long hist_block_bytes(const HistLayout& L) {
  return (long long)L.per * L.C * L.copies * (long long)sizeof(float);
}

// Whether each block's slice fits beside `static_bytes` of static shared
// memory in the `optin_bytes` a block may opt in to.
ARES_HD bool hist_fits(const HistLayout& L, long long static_bytes,
                        long long optin_bytes) {
  return L.n_slots > 0 && L.n_slots <= HIST_MAX_SLOTS && L.C > 0 &&
         hist_block_bytes(L) + static_bytes <= optin_bytes;
}

// the largest cluster a launch takes: 8 blocks, the portable size
#define HIST_MAX_CLUSTER 8
// threads of a block: the most rows in flight with one block an SM
#define HIST_THREADS 1024

// The ranks of the cluster that holds a table of n_slots x C bins, on a
// card whose blocks may opt in to `optin_bytes` of shared memory beside
// `static_bytes` of static shared memory and whose clusters may hold up to
// `max_cluster` blocks: the smallest power of two whose slices fit, or 0
// where none does.
ARES_HD int hist_policy(int n_slots, int C, long long static_bytes,
                        long long optin_bytes, int max_cluster) {
  for (int g = 1; g <= max_cluster; g *= 2)
    if (hist_fits(hist_layout(n_slots, C, g), static_bytes, optin_bytes))
      return g;
  return 0;
}

// How a row reaches the rank that owns its slot (see the top of the file).
#define HIST_SPLIT_TILES 0
#define HIST_SPLIT_DSMEM 1

#ifdef __CUDACC__
#include "ares_cluster.cuh"

// Zero this block's copies of its slice of the cluster table, then wait
// until every rank of the cluster has zeroed its own.
__device__ __forceinline__ void cluster_hist_zero(float* h,
                                                  const HistLayout& L) {
  for (int j = threadIdx.x; j < L.per * L.C * L.copies; j += blockDim.x)
    h[j] = 0.f;
  ares_cluster_sync();
}

// The rows of a launch are cut into parts, each part looped over by
// blockDim.x threads: under HIST_SPLIT_TILES one part per cluster (every
// rank reads it), under HIST_SPLIT_DSMEM one per block.
struct HistPart {
  long long part, n_parts;
};

template <int kSplit>
__device__ __forceinline__ HistPart hist_part(const HistLayout& L) {
  if (kSplit == HIST_SPLIT_DSMEM) return {blockIdx.x, gridDim.x};
  return {blockIdx.x / L.G, gridDim.x / L.G};
}

// Whether this rank adds slot s: s lies in [0, n_slots) and, under
// HIST_SPLIT_TILES, in this rank's range.
template <int kSplit>
__device__ __forceinline__ bool hist_takes(const HistLayout& L, int s) {
  if ((uint32_t)s >= (uint32_t)L.n_slots) return false;
  if (kSplit == HIST_SPLIT_DSMEM || L.G == 1) return true;
  const int local = s - (int)ares_cluster_rank() * L.per;
  return (uint32_t)local < (uint32_t)L.per;
}

// Add channels v[0..C) of one row into slot s of the cluster table, where
// hist_takes<kSplit>(L, s): under HIST_SPLIT_TILES into this rank's shared
// memory, under HIST_SPLIT_DSMEM into the owner's, local or remote.
// Channels from kIntFrom on hold integers (exact below 2^24) and are added
// as unsigned ints.
template <int kSplit, int C, int kIntFrom = C>
__device__ __forceinline__ void cluster_hist_add(float* h,
                                                 const HistLayout& L, int s,
                                                 const float* v) {
  float* p;
  if (L.G == 1) {
    p = h + s * C;
  } else if (kSplit == HIST_SPLIT_TILES) {
    p = h + (s - (int)ares_cluster_rank() * L.per) * C;
  } else {
    const int r = hist_owner(L, s);
    p = ares_cluster_map(h, r) + (s - r * L.per) * C;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < kIntFrom)
      atomicAdd(p + c, v[c]);
    else
      atomicAdd(reinterpret_cast<unsigned*>(p + c), (unsigned)v[c]);
  }
}

// After every rank's adds: this rank's non-zero bins, each summed over the
// block's copies, are added into the zeroed result, bin (slot, c) at
// out[slot * stride_slot + c * stride_ch], with global atomics that
// neighbouring threads issue on neighbouring addresses (channel by
// channel where the result is channel-major). A slice holds bin (local
// slot, c) at local * C + c, or at c * per + local where kChannelMajor.
template <int C, int kIntFrom = C, bool kChannelMajor = false>
__device__ __forceinline__ void cluster_hist_flush(const float* h,
                                                   const HistLayout& L,
                                                   float* out,
                                                   long long stride_slot,
                                                   long long stride_ch) {
  ares_cluster_sync();  // every peer's adds into this slice have landed
  const int lo = (int)ares_cluster_rank() * L.per;
  const int hi = min(lo + L.per, L.n_slots);
  const int n_local = hi > lo ? hi - lo : 0;
  const int slice = L.per * C;
  for (int j = threadIdx.x; j < n_local * C; j += blockDim.x) {
    const int c = stride_slot == 1 ? j / n_local : j % C;
    const int local = stride_slot == 1 ? j - c * n_local : j / C;
    const int bin = kChannelMajor ? c * L.per + local : local * C + c;
    float v;
    if (c < kIntFrom) {
      v = h[bin];
      for (int r = 1; r < L.copies; ++r) v += h[r * slice + bin];
    } else {
      const unsigned* u = reinterpret_cast<const unsigned*>(h);
      unsigned sum = u[bin];
      for (int r = 1; r < L.copies; ++r) sum += u[r * slice + bin];
      v = (float)sum;
    }
    if (v != 0.f)  // NaN != 0: a poisoned bin is flushed
      atomicAdd(out + (long long)(lo + local) * stride_slot +
                    (long long)c * stride_ch,
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

#endif  // __CUDACC__

// The host helpers below: nvcc's build of a whole kernel library compiles
// them; a device-only build (K1's per-plan cubin, ARES_DEVICE_ONLY) does
// not parse them; a host-only build (K1's launcher, under the host
// compiler) asks for them with ARES_HIST_HOST.
#if defined(__CUDACC__) && !defined(ARES_DEVICE_ONLY)
#define ARES_HIST_HOST
#endif

#ifdef ARES_HIST_HOST
#include <cuda_runtime.h>

#include <mutex>
#include <utility>

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

// The card's limits the policy takes: opt-in shared bytes of a block, and
// the largest cluster (HIST_MAX_CLUSTER from compute capability 9 on).
static void hist_device_limits(int device, long long* optin, int* max_cluster) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *optin = v;
  int cc = 0;
  cudaDeviceGetAttribute(&cc, cudaDevAttrComputeCapabilityMajor, device);
  *max_cluster = cc >= 9 ? HIST_MAX_CLUSTER : 0;
}

// How many clusters of G blocks of HIST_THREADS threads with `smem`
// dynamic bytes the card holds at once (cudaOccupancyMaxActiveClusters;
// 0 where the query fails), cached per (kernel, device, G, smem): launches
// must not pay the query. K1's launcher holds every plan structure's
// kernel, so the cache holds HIST_CACHE entries. Also raises the kernel's
// dynamic shared memory limit to the card's opt-in bytes less
// `static_bytes`.
#define HIST_CACHE 1024
template <typename Kernel>
static int hist_max_clusters(Kernel kernel, int device, int G, size_t smem,
                             size_t static_bytes, long long optin) {
  struct Entry {
    const void* fn;
    int device, G;
    size_t smem;
    int clusters;
  };
  static std::mutex mu;
  static Entry cache[HIST_CACHE];
  static int n_cached = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < n_cached; ++k) {
    const Entry& e = cache[k];
    if (e.fn == (const void*)kernel && e.device == device && e.G == G &&
        e.smem == smem)
      return e.clusters;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)(optin - (long long)static_bytes));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(HIST_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = G;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg) !=
      cudaSuccess) {
    clusters = 0;
    cudaGetLastError();  // a launch after this one must not report it
  }
  if (n_cached < HIST_CACHE)
    cache[n_cached++] = {(const void*)kernel, device, G, smem, clusters};
  return clusters;
}

// One launch of a cluster-histogram kernel: the persistent grid and the
// cluster launch attribute.
struct HistLaunch {
  HistLayout L;
  int clusters;
  size_t smem;
};

// Size the persistent grid of `kernel`, whose rows reach their owner by
// kSplit, over n rows, `rows_per_thread` rows to a thread and pass, for a
// decided layout L beside `static_bytes` of static shared memory. Returns
// false where the card holds no cluster of it.
template <int kSplit, typename Kernel>
static bool hist_size(Kernel kernel, int device, const HistLayout& L,
                      size_t static_bytes, long long optin, long long n,
                      int rows_per_thread, HistLaunch* out) {
  const size_t smem = (size_t)hist_block_bytes(L);
  long long clusters =
      hist_max_clusters(kernel, device, L.G, smem, static_bytes, optin);
  if (clusters <= 0) return false;
  // under HIST_SPLIT_TILES a cluster's ranks share its rows
  const long long per_cluster = (long long)HIST_THREADS * rows_per_thread *
                                (kSplit == HIST_SPLIT_DSMEM ? L.G : 1);
  const long long need = (n + per_cluster - 1) / per_cluster;
  if (clusters > need) clusters = need > 0 ? need : 1;
  *out = {L, (int)clusters, smem};
  return true;
}

// The one place a K1 or K2 launch is decided: plan one of `kernel` over n
// rows of a table of n_slots x C bins, one copy a block, in the smallest
// cluster that holds it (hist_policy). Returns false where none does.
template <int kSplit, typename Kernel>
static bool hist_plan(Kernel kernel, int device, int n_slots, int C,
                      size_t static_bytes, long long n, int rows_per_thread,
                      HistLaunch* out) {
  long long optin = 0;
  int max_cluster = 0;
  hist_device_limits(device, &optin, &max_cluster);
  const int G = hist_policy(n_slots, C, (long long)static_bytes, optin,
                            max_cluster);
  if (G <= 0) return false;
  return hist_size<kSplit>(kernel, device, hist_layout(n_slots, C, G),
                           static_bytes, optin, n, rows_per_thread, out);
}

// Launch `kernel` as planned, on `st`: args[k] points at the value of its
// k-th parameter (cudaLaunchKernelExC). `kernel` is a __global__
// function's address or a cudaKernel_t from a loaded image.
static cudaError_t hist_launch_args(const void* kernel, const HistLaunch& h,
                                    cudaStream_t st, void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(h.clusters * h.L.G);
  cfg.blockDim = dim3(HIST_THREADS);
  cfg.dynamicSmemBytes = h.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = h.L.G;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

// Launch `kernel` as planned, on `st`, with its arguments, each converted
// to its parameter's type.
template <typename... Params, typename... Args>
static cudaError_t hist_launch(void (*kernel)(Params...), const HistLaunch& h,
                               cudaStream_t st, Args&&... args) {
  return [&](Params... typed) {
    void* argv[] = {(void*)&typed...};
    return hist_launch_args((const void*)kernel, h, st, argv);
  }(std::forward<Args>(args)...);
}

#endif  // ARES_HIST_HOST
