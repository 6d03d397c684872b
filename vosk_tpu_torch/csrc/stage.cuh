// Staging a channel's table row in shared memory by TMA bulk copy, shared
// by the expand kernel (csrc/frame_step.cu) and the gather kernel
// (csrc/gather.cu).
//
// One block: thread 0 starts one 1-D bulk copy (cp.async.bulk) of the row
// at block entry, completing on an mbarrier; the block does its own loads
// while the copy is in flight and waits only before its lookups.
//
// A cluster of C blocks that read the same row (the tiles of one channel,
// launched with cudaLaunchKernelEx and a cluster dimension): each block
// starts a 1/C slice of the row as one bulk copy multicast to every block
// of the cluster, so the row is read from L2 once per cluster and not once
// per block.  Each block's mbarrier expects the whole row's bytes; a peer's
// slice may land before this block's own arrive, which the mbarrier allows
// (its phase cannot complete while the arrival is pending).  Ordering: a
// cluster barrier sits after every block's mbarrier init and before any
// copy is issued, so no slice reaches a barrier that is not yet set up; no
// block may exit before its own barrier completes, since peers write into
// its shared memory until then.  Every thread of every block of the
// cluster calls stage_begin and stage_wait, whether it has work or not.
//
// The row's source address and byte count must be multiples of 16 (the
// bulk copy's rule); the caller reads in place otherwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace vt_stage {

constexpr int kMaxDevices = 64;
constexpr int kStageReserve = 64;  // a staging kernel's static shared memory, at most
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The calling block's rank in its cluster and the cluster's size (0 and 1
// for a launch without clusters: every block is then a cluster of one).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stage n words of src into row (a dynamic shared-memory array at the same
// offset in every block of the cluster), completing on bar.  n % 4 == 0
// and src 16-byte aligned; n may be 0 (nothing is copied).
__device__ __forceinline__ void stage_begin(void* row, uint64_t* bar, const void* src, int n) {
  const uint32_t C = cluster_size();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (C > 1) {
    cluster_sync();  // every peer's barrier is set up before any slice is sent
  } else {
    __syncthreads();
  }
  if (threadIdx.x != 0 || n <= 0) return;
  const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (C == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(row)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
    return;
  }
  // this block's slice: whole 16-byte units, the last slices may be short
  // or empty
  const uint32_t units = bytes / 16u;
  const uint32_t per = (units + C - 1) / C;
  const uint32_t r = cluster_rank();
  const uint32_t u0 = r * per < units ? r * per : units;
  const uint32_t u1 = u0 + per < units ? u0 + per : units;
  if (u1 == u0) return;
  const uint16_t mask = static_cast<uint16_t>((1u << C) - 1u);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(row) + u0 * 16u),
      "l"(static_cast<const char*>(src) + static_cast<size_t>(u0) * 16u),
      "r"((u1 - u0) * 16u), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// Wait until the n words staged by stage_begin have landed in this block.
__device__ __forceinline__ void stage_wait(uint64_t* bar, int n) {
  if (n <= 0) return;
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(0u)
      : "memory");
}

// ------------------------------------------------------------------ host

// Blocks a cluster takes for a channel of `tiles` blocks: the fewest
// clusters of at most 8 (each reads the row from L2 once), then the least
// padding (blocks past the last tile, which only take part in the copy).
inline int cluster_for(int tiles) {
  int best = 1;
  long long best_n = tiles, best_pad = 0;
  for (int C = 2; C <= 8 && C <= tiles; ++C) {
    const long long n = (tiles + C - 1) / C, pad = n * C - tiles;
    if (n < best_n || (n == best_n && pad < best_pad)) {
      best = C;
      best_n = n;
      best_pad = pad;
    }
  }
  return best;
}

// The current device's SM count (the runtime answers from its own cache).
inline int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

// The dynamic shared memory a block may stage its row in: the current
// device's opt-in limit less the kernel's static part.
inline int stage_smem_limit() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return kStaticSmemLimit - kStageReserve;
  return n - kStageReserve;
}

// Let kernel fn take `bytes` of dynamic shared memory on the current
// device, once per device (the attribute is per device; `done` is the
// kernel's own flags).
template <class F>
cudaError_t allow_smem(F* fn, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

// A launch of `grid` blocks of `threads` in clusters of C along x (grid.x a
// multiple of C), for cudaLaunchKernelEx; attr must outlive the launch.
inline cudaLaunchConfig_t cluster_config(dim3 grid, unsigned threads, int C, size_t smem,
                                         cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace vt_stage
