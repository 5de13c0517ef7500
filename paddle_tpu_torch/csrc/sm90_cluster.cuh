// Thread-block clusters on Hopper (sm_90a), as the recurrent backward
// kernels use them (csrc/lstm_seq_bwd.cu, csrc/gru_seq_bwd.cu): the cluster
// barrier split into arrive and wait; the 2- and 4-value vector stores and
// loads of the float32 exchange buffers that a block fills in its peers'
// shared memory (distributed shared memory, addressed through
// cooperative_groups::cluster_group::map_shared_rank; the 2-value load
// also reads a W slice in either dtype); and, on the host, the launch of a
// grid of clusters (cudaLaunchKernelEx) and the card's limits that a
// planner sizes a cluster layout by (cudaOccupancyMaxActiveClusters).
//
// Ordering: stores made before cluster_arrive() (release) are visible to
// every thread of the cluster after its cluster_wait() (acquire) returns.
// Every thread of every block of the cluster executes each barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// 4 consecutive float32 values: one 16-byte access
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 2 consecutive values: one 8-byte (float32) or 4-byte (bfloat16) access
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// clusters of more blocks than this need the non-portable size attribute
constexpr int kPortableClusterSize = 8;

// Let ``kernel`` take ``smem`` bytes of dynamic shared memory and clusters
// of ``size`` blocks. Returns 0 or a cudaError_t value.
inline int cluster_attributes(const void* kernel, int size, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && size > kPortableClusterSize) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return static_cast<int>(err);
}

// One launch of ``kernel`` (threads x 1 x 1 blocks) over a grid of ``size``
// x ``tiles`` blocks in clusters of ``size`` x 1 x 1: one cluster per batch
// tile (blockIdx.y), its blocks the unit tiles (blockIdx.x == the block's
// rank in the cluster). Clusters that do not fit on the card at once run
// later; nothing passes between clusters. Returns 0 or the cudaError_t of
// the launch or of cudaGetLastError() after it (a refused launch raises in
// the caller; nothing falls back).
inline int launch_clusters(const void* kernel, int size, int tiles,
                           int threads, int smem, cudaStream_t stream,
                           void** args) {
  int rc = cluster_attributes(kernel, size, smem);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size, tiles, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of ``size`` blocks of ``kernel`` the card holds at
// once with ``smem`` bytes of dynamic shared memory per block (0 where it
// cannot launch such a cluster at all). Returns 0 or a cudaError_t value.
inline int max_active_clusters(const void* kernel, int size, int threads,
                               int smem, int* out) {
  *out = 0;
  int rc = cluster_attributes(kernel, size, smem);
  if (rc != 0) {
    cudaGetLastError();
    return size > kPortableClusterSize ? 0 : rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    *out = 0;
    // a size above the portable limit that the card does not offer
    return size > kPortableClusterSize ? 0 : static_cast<int>(err);
  }
  return 0;
}

// The card's limits that a planner sizes a cluster layout of ``kernel``
// (``threads`` a block) by: out = {SM count, opt-in dynamic shared memory
// per block in bytes, the clusters of 8 and of 16 blocks of ``kernel`` the
// card holds at once at the full opt-in shared memory, i.e. one block per
// SM (0 where it cannot launch such a cluster)}. Returns 0 or a
// cudaError_t value.
inline int card_limits(const void* kernel, int threads, int device,
                       int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&out[1],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = max_active_clusters(kernel, 8, threads, out[1], &out[2]);
  if (rc != 0) return rc;
  return max_active_clusters(kernel, 16, threads, out[1], &out[3]);
}

}  // namespace sm90
