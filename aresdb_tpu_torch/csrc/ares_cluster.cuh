// Thread-block cluster helpers of the cluster histogram (block_hist.cuh)
// and K3: the built-ins that cooperative_groups' cluster_group calls on
// sm_90 (cooperative_groups/details/helpers.h, namespace cluster), called
// directly. So the device code includes no <cooperative_groups.h>, and
// K1's per-structure compile under NVRTC reaches no toolkit header; the
// instructions are cluster_group's own.
#pragma once

#ifdef __CUDACC__
// cluster_group::sync(): every thread of every block of the cluster
// arrives, then waits for the others; shared-memory writes before it are
// visible to the cluster's blocks after it.
__device__ __forceinline__ void ares_cluster_sync() {
  __cluster_barrier_arrive();
  __cluster_barrier_wait();
}

// cluster_group::block_rank(): this block's rank in its cluster.
__device__ __forceinline__ unsigned ares_cluster_rank() {
  return __clusterRelativeBlockRank();
}

// cluster_group::map_shared_rank(): the address of *ptr, a shared-memory
// variable of this block, in the shared memory of the cluster's block
// `rank`.
template <typename T>
__device__ __forceinline__ T* ares_cluster_map(T* ptr, int rank) {
  return static_cast<T*>(__cluster_map_shared_rank(ptr, rank));
}
#endif  // __CUDACC__
