// Per-row table gather for Hopper: out[b, n] = table[b, idx[b, n]].
//
// Replaces vosk_tpu/ops/gather.py:_pallas_gather, the TPU kernel that keeps
// one channel's table in VMEM and does a lane gather per index tile.  The
// port's v3 decoder calls it at the source's four v3 sites: the acoustic
// lookup ll[b, pdf] (table [B, 6008] f32, N = K*M indices per channel),
// the trailing-silence lookups tsil[b, prev] (table [B, K] int32, N = K)
// and an eps round's state[b, src] (N = its budget of eps sources).
//
// What bounds it: nothing here is arithmetic.  Each output costs one index
// load, one table read and one store, so the kernel is bound by memory
// latency and bytes: the index and output streams are sequential, the
// table reads random.
//
// What the design does about it (grid of 4096-index tiles x B, 256
// threads, 16 indices a thread):
//  * the table row's copy into shared memory starts first, one TMA bulk
//    copy at block entry completing on an mbarrier (csrc/stage.cuh), and
//    overlaps the block's index loads; where a channel has several tiles,
//    they run as a thread-block cluster and each multicasts a slice of the
//    row to all of them, so the row leaves L2 once per cluster, not once
//    per tile;
//  * every index of a thread is loaded, as 16-byte vectors, before its
//    first lookup, and the outputs are stored as 16-byte vectors; only a
//    tile's ragged ends (fewer than 4 elements each side of its whole
//    vectors) go scalar;
//  * the row is read in place, through the read-only path, where staging
//    does not pay: a channel with fewer lookups than its row has words (an
//    eps round's state lookup) or than 1,024 (a grammar's tsil lookup), a
//    row above the shared-memory opt-in, or a row the bulk copy cannot take
//    (not 16-byte aligned, or P % 4 != 0).  Multicast pays only where the
//    grid holds more than two blocks an SM; below that, each block's own
//    copy is quicker than a cluster's barrier (PERF.md, PR 15).
// Elements are copied as 32-bit words, so float32 and int32 tables go
// through the same kernel bit for bit.  An index outside [0, P) yields 0.
//
// Plain C interface (loaded with ctypes by vosk_tpu_torch/ops/gather.py):
// the kernel launches on the caller's stream, allocates nothing, does not
// synchronise, and the function returns cudaGetLastError() (a cluster
// launch the device refuses returns its error; nothing falls back).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                  // indices a thread
constexpr int kTile = kThreads * kPer;    // indices a block
constexpr int kVecs = kPer / 4;           // int4 loads a thread
constexpr int kFewLookups = 1024;         // a channel's lookups below which staging does not pay

__device__ __forceinline__ uint32_t lookup(const uint32_t* row, int P, int32_t j, bool staged) {
  if (static_cast<uint32_t>(j) >= static_cast<uint32_t>(P)) return 0u;
  return staged ? row[j] : __ldg(row + j);
}

// A tile's elements from the first 16-byte boundary of idx on move as
// int4 (thread t takes vectors t, t + 256, ...; out lies at the same offset
// from a 16-byte boundary, which the wrapper arranges), and the < 4
// elements before it and after the last whole vector move one a thread.
// Blocks past the channel's last tile (a cluster's padding) move nothing
// but take part in the row's copy.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                   uint32_t* __restrict__ out, int P, int N) {
  extern __shared__ __align__(16) uint32_t srow[];
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.y;
  const uint32_t* trow = table + static_cast<size_t>(b) * P;
  if (kStaged) vt_stage::stage_begin(srow, &bar, trow, P);
  const uint32_t* row = kStaged ? srow : trow;
  const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
  const int len = n0 < N ? static_cast<int>(N - n0 < kTile ? N - n0 : kTile) : 0;
  const long long f0 = static_cast<long long>(b) * N + n0;  // flat index of the tile's start
  const int t = threadIdx.x;
  const int32_t* ib = idx + f0;
  uint32_t* ob = out + f0;
  const int head =
      min(static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(ib) & 15u)) & 15u) >> 2), len);
  const int nv = (len - head) >> 2;
  const int tail = len - head - 4 * nv;
  const int4* iv = reinterpret_cast<const int4*>(ib + head);
  uint4* ov = reinterpret_cast<uint4*>(ob + head);
  int4 v[kVecs];
  int32_t h = 0, z = 0;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int q = t + i * kThreads;
    v[i] = q < nv ? __ldg(iv + q) : make_int4(0, 0, 0, 0);
  }
  if (t < head) h = __ldg(ib + t);
  if (t < tail) z = __ldg(ib + head + 4 * nv + t);
  if (kStaged) vt_stage::stage_wait(&bar, P);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int q = t + i * kThreads;
    if (q < nv) {
      uint4 o;
      o.x = lookup(row, P, v[i].x, kStaged);
      o.y = lookup(row, P, v[i].y, kStaged);
      o.z = lookup(row, P, v[i].z, kStaged);
      o.w = lookup(row, P, v[i].w, kStaged);
      ov[q] = o;
    }
  }
  if (t < head) ob[t] = lookup(row, P, h, kStaged);
  if (t < tail) ob[head + 4 * nv + t] = lookup(row, P, z, kStaged);
}

template <bool kStaged>
cudaError_t launch_gather(dim3 grid, int C, cudaStream_t s, const uint32_t* table,
                          const int32_t* idx, uint32_t* out, int P, int N) {
  auto* kern = gather_rows_kernel<kStaged>;
  const size_t smem = kStaged ? static_cast<size_t>(P) * 4 : 0;
  if (smem > vt_stage::kStaticSmemLimit - vt_stage::kStageReserve) {
    static std::atomic<bool> done[vt_stage::kMaxDevices];
    const cudaError_t err = vt_stage::allow_smem(kern, vt_stage::stage_smem_limit(), done);
    if (err != cudaSuccess) return err;
  }
  if (C > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = vt_stage::cluster_config(grid, kThreads, C, smem, s, &attr);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, table, idx, out, P, N);
    if (err != cudaSuccess) return err;
  } else {
    gather_rows_kernel<kStaged><<<grid, kThreads, smem, s>>>(table, idx, out, P, N);
  }
  return cudaGetLastError();
}

}  // namespace

// stage_req: -1 lets the kernel choose by shape (below); 0 reads the row in
// place, 1 stages it in each block, 2 multicasts it over a cluster of the
// channel's tiles (a row the bulk copy cannot take, or too long for shared
// memory, is read in place whatever is asked).  idx and out lie at the
// same offset from a 16-byte boundary.
extern "C" int vt_gather_rows(const void* table, const void* idx, void* out, int B, int P,
                              int N, int stage_req, void* stream) {
  if (B <= 0 || P < 0 || N <= 0 || stage_req < -1 || stage_req > 2 ||
      reinterpret_cast<uintptr_t>(idx) % 16 != reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(idx) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + kTile - 1) / kTile;
  const bool fits = reinterpret_cast<uintptr_t>(table) % 16 == 0 && P > 0 && P % 4 == 0 &&
                    static_cast<long long>(P) * 4 <= vt_stage::stage_smem_limit();
  // The kernel's own choice, from the card's interleaved times (PERF.md):
  // a channel with fewer lookups than its row has words, or than
  // kFewLookups, reads in place (the copy and its wait cost more than the
  // lookups); else each block stages the row, multicast over a cluster of
  // the channel's tiles where the grid holds more than two blocks an SM
  // (each SM then copies the row for several blocks: the v3 ll site's 14
  // tiles a channel at B = 32, the split graph's 455 at B = 1).
  int mode = stage_req;
  if (!fits || (mode < 0 && (N < P || N < kFewLookups))) {
    mode = 0;
  } else if (mode < 0) {
    mode = tiles > 1 && static_cast<long long>(tiles) * B > 2LL * vt_stage::num_sms() ? 2 : 1;
  }
  const int C = mode == 2 ? vt_stage::cluster_for(tiles) : 1;
  const dim3 grid(static_cast<unsigned>((tiles + C - 1) / C * C), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint32_t*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  const cudaError_t err = mode == 0 ? launch_gather<false>(grid, C, s, t, i, o, P, N)
                                    : launch_gather<true>(grid, C, s, t, i, o, P, N);
  return static_cast<int>(err);
}
