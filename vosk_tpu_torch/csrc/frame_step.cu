// The v4 frame step for Hopper: expand, then select.
//
// Together they replace vosk_tpu/ops/gather.py:_pallas_gather, the TPU
// kernel that the JAX decoder calls twice per frame, with the work around
// each call:
//   expand_v4_kernel   vosk_tpu/ops/viterbi.py _unpack_rows_v4 + _expand_v4
//                      (:833-894), with the acoustic lookup ll[b, pdf] (:879);
//   select_v4 (two     the source's pool sort and _select_v4
//   launches)          (_frame_step_v4 :896-906, _select_v4 :1057-1155): the
//                      dedup by next state, the re-rank, the beam prune, the
//                      trailing-silence lookup tsil[b, prev] (:1105), the
//                      new frontier and the five record planes.
// No sort, gather or other torch op runs between or around them.  Plain
// versions and wrappers: vosk_tpu_torch/ops/frame_step.py.
//
// What bounds them.  Expand: bytes.  It does no more than a few integer
// and one fused multiply-add per element and moves about 20.5 MB per frame
// at B = 32, K = 7000, M = 4 with every token live (arc rows 7.2 MB, three
// [B, K*M] outputs 10.8 MB).  Select needs only the pool's keys (4 bytes a
// candidate, 3.6 MB at B = 32), the payload of the candidates within reach
// of the beams and its outputs, but its time is latency: one block per
// channel runs three sorts, their block barriers and dependent loads one
// after another, and at B = 1 the two launches and that chain are all of
// it (PERF.md).  The source's three stable sorts of the whole pool and
// their payload gathers moved many times the bytes, in about a dozen
// launches.
//
// What the design does about it:
//  * one pass each: the indices of the old gather never reach device
//    memory, and no [B, K*M] intermediate is written between the arc-row
//    read and the cost keys;
//  * grids of (element tiles, B), so B = 32 gives ~900 blocks of 256
//    threads (the old gather ran 7 or 2 blocks per channel);
//  * expand, while the grid has no more blocks than the card has SMs
//    (B = 1): one thread of each block starts a 1-D bulk copy (TMA,
//    cp.async.bulk) of the channel's ll row into shared memory at block
//    start, completing on an mbarrier; the block loads its tokens' states,
//    costs and arc rows while the copy is in flight and waits only before
//    the lookups.  Only the first 2^14 words are staged (packed16 rows
//    hold pdf ids below 2^14), so at most 64 KB of shared memory is
//    needed.  With more blocks than SMs (B = 32, or wide rows) the lookups
//    read the row in place through the read-only path: blocks of a channel
//    then share an SM's L1, and staging would copy the row once per block
//    (chip_smoke.py times both choices at each shape).  A row whose start
//    or length is not a multiple of 16 bytes, which the bulk copy cannot
//    take, is read in place too;
//  * expand at M = 4: one thread per token reads its 32-byte row as two
//    16-byte loads and writes its four candidates as 16-byte stores; other
//    M: one thread per candidate;
//  * expand: a dead token (state S) reads no row and writes (BIG, S, prevm)
//    directly: row S is all padding (w = +inf, next = S, sil = 0);
//  * select needs no order of the whole pool.  Only candidates within
//    best + beam can become kept frontier tokens, and only those within
//    (best + beam) + lattice_beam kept lattice rows (f32 addition is
//    monotone; best, the pool's smallest key, always wins its state).
//    Pass 1 (grid of 4096-candidate tiles x B) reads each key once,
//    folds the channel's minimum in with atomicMin, and appends the
//    candidates within the range its own tile minimum gives (a superset
//    of the channel's) to one list per channel through an atomic count;
//    real frames keep a few hundred per channel of 28,000, and the padding
//    slots of wide rows (1.86 M candidates a frame on a split graph) never
//    leave their tile.  Pass 2 (one 1024-thread block per channel) takes
//    the channel's minimum and range, gathers the in-range candidates,
//    cuts them to the N = max(R, K2) first by (key, e) where more remain
//    than its sort holds (the whole pool can be in range under load) with
//    radix selects over the list: the key at the cut, then, where that
//    key's run straddles the cut, the e at the run's rank, so ties go to
//    the lowest e as the source's stable sort gives them and the list
//    needs no order.  It then ranks with three bitonic sorts of 64-bit
//    keys: (key, e) for the lattice rows and the dedup set, (state, rank)
//    for the dedup, (key, state order) for the new frontier.  Each sort
//    runs on tiles of 256 keys held in a warp's registers, with memory and
//    a barrier only for the stages that cross tiles, and only warps with a
//    tile take part.  Up to N = 16,384 (max-active 8,192) the keys live in
//    192 KB of shared memory; above, in per-channel rows of global scratch
//    (L2-resident at these sizes), with the same code.  It reads nsm, pm and the
//    old tsil of those candidates only, and writes the frontier and the
//    record rows once;
//  * a thread-block cluster over a channel's pool was not needed: pass 1
//    spreads the pool over the card, and pass 2 sorts what is left.
// Pass 2 resets pass 1's per-channel minimum and count for the next call
// once it has read them; the wrapper sets them once, at allocation.  The
// shared-memory opt-in of a kernel is set once per device.
//
// Bit parity with the JAX decoder on the CPU: the cost is
// fma(-scale, ac, tok_cost + w) with both roundings explicit (XLA contracts
// the source's expression the same way; no plain * or + that nvcc could
// contract); the f16 weight is converted with __half2float; cost keys use
// unsigned arithmetic (signed overflow is undefined in C++); the beam and
// lattice-beam thresholds are __fadd_rn, as the source adds them in f32.
//
// Plain C interface (loaded with ctypes): each function launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 256;             // select_v4 pass 1
constexpr int kScanPer = 16;                   // candidates per pass-1 thread
constexpr int kTile = kScanThreads * kScanPer;  // candidates per pass-1 block
constexpr int kRankThreads = 1024;             // select_v4 pass 2: one block per channel
constexpr int kCap = 16384;                    // candidates pass 2 sorts in shared memory
constexpr int kRankBits = 14;                  // log2(kCap)
constexpr size_t kRankSmem = static_cast<size_t>(kCap) * (8 + 4);
constexpr int kHistBits = 11;                  // radix digit of the cuts
constexpr size_t kHistSmem = static_cast<size_t>(4) << kHistBits;  // histogram, global pass 2
constexpr int kMaxDevices = 64;
constexpr uint64_t kNone = ~0ull;              // sorts after every real sort key
constexpr int32_t kNoKey = -2147483647 - 1;
constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int32_t kPosInfKey = 0x7F800000;    // cost key of +inf (-inf: -kPosInfKey)
constexpr int32_t kNsMask = (1 << 30) - 1;
constexpr int32_t kPmSil = 1 << 30;
constexpr int32_t kPmIdent = 1 << 29;
constexpr int32_t kPmMask = (1 << 29) - 1;
constexpr int32_t kSpeech = 1 << 21;
constexpr int32_t kTsilMask = (1 << 21) - 1;
constexpr int kPdfWords = 1 << 14;             // packed16: pdf ids below 2^14
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ int32_t cost_key(float c) {
  const int32_t b = __float_as_int(c);
  return b < 0 ? static_cast<int32_t>(0x80000000u - static_cast<uint32_t>(b)) : b;
}

__device__ __forceinline__ float key_cost(int32_t k) {
  return __int_as_float(
      k < 0 ? static_cast<int32_t>(0x80000000u - static_cast<uint32_t>(k)) : k);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage n words of src into row by one bulk copy completing on bar.  Every
// thread of the block calls both halves.
__device__ __forceinline__ void stage_begin(float* row, uint64_t* bar, const float* src,
                                            int n) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(row)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void stage_wait(uint64_t* bar, int n) {
  if (n == 0) return;
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0u)
        : "memory");
  } while (!done);
}

// One candidate of a live token: (cost key, next state, pm word); row is
// the ll row in shared memory when kStaged, else in global memory.
template <bool kStaged>
__device__ __forceinline__ void score(int32_t p1, int32_t nsf, float tok_cost,
                                      const float* row, int n_stage, float neg_scale,
                                      int32_t prevm, int S, int32_t& cb, int32_t& ns,
                                      int32_t& pm) {
  const uint32_t u = static_cast<uint32_t>(p1);
  const float w = __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
  const int32_t sil = static_cast<int32_t>((u >> 14) & 1u);
  const int pdf = static_cast<int>(u & 0x3FFFu);
  pm = prevm + (sil << 30);
  if (isfinite(w)) {
    const float ac = pdf < n_stage ? (kStaged ? row[pdf] : __ldg(row + pdf)) : 0.0f;
    cb = cost_key(__fmaf_rn(neg_scale, ac, __fadd_rn(tok_cost, w)));
    ns = nsf & kNsMask;
  } else {
    cb = kBig;
    ns = S;
  }
}

template <bool kVec4, bool kStaged>
__global__ void __launch_bounds__(kThreads)
expand_v4_kernel(const int32_t* __restrict__ em_pack, const int32_t* __restrict__ tok_state,
                 const float* __restrict__ tok_cost, const float* __restrict__ ll,
                 long long ll_stride, int n_stage, float neg_scale, int K, int S, int M,
                 int mbits, int32_t* __restrict__ cbits, int32_t* __restrict__ nsm,
                 int32_t* __restrict__ pm) {
  extern __shared__ __align__(16) float smem_row[];
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.y;
  const float* ll_row = ll + static_cast<long long>(b) * ll_stride;
  if (kStaged) stage_begin(smem_row, &bar, ll_row, n_stage);
  const float* row = kStaged ? smem_row : ll_row;
  const long long E = static_cast<long long>(K) * M;
  if (kVec4) {  // M == 4: one thread per token
    const int k = blockIdx.x * kThreads + threadIdx.x;
    const bool in = k < K;
    const long long tok = static_cast<long long>(b) * K + k;
    const int s = in ? tok_state[tok] : S;
    float tc = 0.0f;
    int4 p1 = make_int4(0, 0, 0, 0), nx = p1;
    if (s != S) {
      tc = tok_cost[tok];
      const int4* r = reinterpret_cast<const int4*>(em_pack + static_cast<long long>(s) * 8);
      p1 = __ldg(r);
      nx = __ldg(r + 1);
    }
    if (kStaged) stage_wait(&bar, n_stage);
    if (!in) return;
    const int32_t pm0 = k << mbits;
    int4 oc, on, op;
    if (s == S) {
      oc = make_int4(kBig, kBig, kBig, kBig);
      on = make_int4(S, S, S, S);
      op = make_int4(pm0, pm0 | 1, pm0 | 2, pm0 | 3);
    } else {
      score<kStaged>(p1.x, nx.x, tc, row, n_stage, neg_scale, pm0, S, oc.x, on.x, op.x);
      score<kStaged>(p1.y, nx.y, tc, row, n_stage, neg_scale, pm0 | 1, S, oc.y, on.y, op.y);
      score<kStaged>(p1.z, nx.z, tc, row, n_stage, neg_scale, pm0 | 2, S, oc.z, on.z, op.z);
      score<kStaged>(p1.w, nx.w, tc, row, n_stage, neg_scale, pm0 | 3, S, oc.w, on.w, op.w);
    }
    const long long e0 = static_cast<long long>(b) * E + 4LL * k;
    *reinterpret_cast<int4*>(cbits + e0) = oc;
    *reinterpret_cast<int4*>(nsm + e0) = on;
    *reinterpret_cast<int4*>(pm + e0) = op;
  } else {  // any M: one thread per candidate e = k*M + m (E < 2^31)
    const int e = blockIdx.x * kThreads + threadIdx.x;
    const bool in = e < E;
    const int k = in ? e / M : 0;
    const int m = in ? e - k * M : 0;
    const long long tok = static_cast<long long>(b) * K + k;
    const int s = in ? tok_state[tok] : S;
    float tc = 0.0f;
    int32_t p1 = 0, nx = 0;
    if (s != S) {
      tc = tok_cost[tok];
      const int32_t* r = em_pack + static_cast<long long>(s) * 2 * M;
      p1 = __ldg(r + m);
      nx = __ldg(r + M + m);
    }
    if (kStaged) stage_wait(&bar, n_stage);
    if (!in) return;
    const int32_t prevm = (k << mbits) | m;
    int32_t oc = kBig, on = S, op = prevm;
    if (s != S) score<kStaged>(p1, nx, tc, row, n_stage, neg_scale, prevm, S, oc, on, op);
    const long long o = static_cast<long long>(b) * E + e;
    cbits[o] = oc;
    nsm[o] = on;
    pm[o] = op;
  }
}

// ------------------------------------------------------------- select_v4

// A block-wide exclusive prefix sum of v over kN threads; *total gets the
// sum.  Every thread of the block calls it (it synchronises).
template <int kN>
__device__ __forceinline__ int block_excl_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kN / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kN / 32) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kN / 32 - 1];
  const int r = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
  __syncthreads();  // s_warp is free for the next call
  return r;
}

// The block-wide minimum of v over kN threads.
template <int kN>
__device__ __forceinline__ int32_t block_min(int32_t v, int* s_warp) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kN / 32; ++w) v = min(v, s_warp[w]);
  __syncthreads();
  return v;
}

// Cost keys as unsigned, in the same order: the high word of a sort key.
__device__ __forceinline__ uint32_t ukey(int32_t k) { return static_cast<uint32_t>(k) ^ 0x80000000u; }

__device__ __forceinline__ int32_t key_of(uint64_t c) {
  return static_cast<int32_t>(static_cast<uint32_t>(c >> 32) ^ 0x80000000u);
}

struct Thresholds {
  int32_t keep;    // a winner is kept iff its key <= keep (and < BIG)
  uint32_t range;  // the largest unsigned key that can still matter
};

// The two cuts a channel's best key fixes.  keep: the beam, as the source
// computes it from the best winner.  range: every candidate that can
// become a kept winner (key <= keep) or a kept lattice row.  A kept
// lattice row costs at most wk + lattice_beam, and wk, the worst finite
// kept winner, is at most f = best + beam (or -inf), so at most f +
// lattice_beam in f32: addition rounds monotonically.  A NaN f keeps no
// finite winner when its key is below every finite key, and any when above.
// Monotone in best, so a tile's own minimum gives a superset of its range.
__device__ __forceinline__ Thresholds thresholds(int32_t best, float beam, float lattice_beam) {
  const float f = __fadd_rn(key_cost(best), beam);
  const int32_t keep = cost_key(f);
  float u = isnan(f) ? (keep > 0 ? INFINITY : -INFINITY) : __fadd_rn(f, lattice_beam);
  if (isnan(u)) u = INFINITY;
  const int32_t r = min(max(keep, cost_key(u)), kBig - 1);  // BIG: never in range
  return {keep, ukey(r)};
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int m) {
  const uint32_t lo = __shfl_xor_sync(0xFFFFFFFFu, static_cast<uint32_t>(v), m);
  const uint32_t hi = __shfl_xor_sync(0xFFFFFFFFu, static_cast<uint32_t>(v >> 32), m);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Bitonic stages j = j0, j0 / 2, ..., 1 of phase k on a tile of 256 sort
// keys that a warp holds in registers: lane l holds elements [g0, g0 + 8),
// g0 = tile start + 8 l.  Stages j >= 8 pair lanes (a shuffle), the others
// pair registers of one lane.
__device__ __forceinline__ void tile_stages(uint64_t (&v)[8], int g0, int k, int j0) {
  for (int j = j0; j >= 8; j >>= 1) {
    const int m = j >> 3;
    const bool keep_min = ((g0 & k) == 0) == ((threadIdx.x & m) == 0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint64_t o = shfl_xor64(v[r], m);
      v[r] = keep_min ? min(v[r], o) : max(v[r], o);
    }
  }
#pragma unroll
  for (int j = 4; j >= 1; j >>= 1) {
    if (j > j0) continue;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r & j) continue;
      const uint64_t p = v[r], q = v[r | j];
      const bool asc = ((g0 + r) & k) == 0;
      v[r] = asc ? min(p, q) : max(p, q);
      v[r | j] = asc ? max(p, q) : min(p, q);
    }
  }
}

// Where sorted rank i lies in shared memory.  A lane's 8 keys [8 l, 8 l +
// 8) would sit 64 bytes after its neighbour's, 16 lanes to a bank; XOR-ing
// bits 0-2 of the index with bits 4-6 spreads each load of a tile over all
// banks, and keeps 32 neighbouring indices on 32 neighbouring slots.  Only
// the sort and the readers of its result use it: the order of its input
// does not matter.
__device__ __forceinline__ int sw(int i) { return i ^ ((i >> 4) & 7); }

__device__ __forceinline__ void tile_load(uint64_t (&v)[8], const uint64_t* a, int g0) {
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = a[sw(g0 + r)];
}

__device__ __forceinline__ void tile_store(const uint64_t (&v)[8], uint64_t* a, int g0) {
#pragma unroll
  for (int r = 0; r < 8; ++r) a[sw(g0 + r)] = v[r];
}

// A barrier for the first `threads` threads of the block (a multiple of
// 32); barrier 0 is __syncthreads.
__device__ __forceinline__ void sync_first(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Sort a[0, n) ascending into rank order a[sw(i)], n a power of two of at
// least 256, whatever the order of a[0, n) on entry: a bitonic
// network over tiles of 256 keys.  Each warp sorts its tiles in registers
// (phases up to 256), then each later phase runs its stages of j >= 256
// over a (shared or global memory) and the rest in registers again, so
// that only log2(n / 256) (log2(n / 256) + 1) / 2 stages touch memory and
// a block barrier.  Only warps with a tile take part.  Every thread of the
// block calls it; it ends with __syncthreads.
__device__ void bitonic_sort(uint64_t* a, int n) {
  const int tiles = n / 256;
  const int warps = min(tiles, static_cast<int>(blockDim.x) / 32), active = warps * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < warps) {
    uint64_t v[8];
    for (int t = warp; t < tiles; t += warps) {
      const int g0 = t * 256 + lane * 8;
      tile_load(v, a, g0);
      for (int k = 2; k <= 256; k <<= 1) tile_stages(v, g0, k, k >> 1);
      tile_store(v, a, g0);
    }
    for (int k = 512; k <= n; k <<= 1) {
      for (int j = k >> 1; j >= 256; j >>= 1) {
        sync_first(active);
        for (int i = threadIdx.x; i < n / 2; i += active) {
          const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo + j;
          const uint64_t p = a[sw(lo)], q = a[sw(hi)];
          if ((p > q) == ((lo & k) == 0)) {
            a[sw(lo)] = q;
            a[sw(hi)] = p;
          }
        }
      }
      sync_first(active);
      for (int t = warp; t < tiles; t += warps) {
        const int g0 = t * 256 + lane * 8;
        tile_load(v, a, g0);
        tile_stages(v, g0, k, 128);
        tile_store(v, a, g0);
      }
    }
  }
  __syncthreads();
}

// The sort size for n keys: a power of two of at least one tile (256).
__device__ __forceinline__ int sort_size(int n) {
  int p = 256;
  while (p < n) p <<= 1;
  return p;
}

// Pad a[n, sort_size(n)) with kNone and sort.  Called by every thread.
__device__ void pad_and_sort(uint64_t* a, int n) {
  const int p = sort_size(n);
  for (int i = n + threadIdx.x; i < p; i += blockDim.x) a[i] = kNone;
  __syncthreads();
  bitonic_sort(a, p);
}

// A slot in an array filled through *count for each thread whose `keep`
// is set: one atomic per warp.  Every lane of the warp calls it.
__device__ __forceinline__ int warp_append(bool keep, int* count) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
  const int lane = threadIdx.x & 31, leader = m ? __ffs(m) - 1 : 0;
  int base = 0;
  if (m && lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xFFFFFFFFu, base, leader);
  return base + __popc(m & ((1u << lane) - 1u));
}

// Pass 1, grid (tiles of kTile candidates, B): the channel's smallest key
// (atomicMin into best[b]), and per tile the candidates within the range
// that the tile's own minimum gives, appended to the channel's list as
// sort keys (unsigned key << 32 | e) through count[b].  The tile minimum
// is at least the channel's best, so the list holds every candidate of the
// channel that is in its range.  Pass 2 resets best[b] and count[b].
__global__ void __launch_bounds__(kScanThreads)
select_v4_scan_kernel(const int32_t* __restrict__ cbits, long long E,
                      const uint8_t* __restrict__ valid, long long valid_stride, float beam,
                      float lattice_beam, int32_t* __restrict__ best, int32_t* __restrict__ count,
                      uint64_t* __restrict__ list) {
  __shared__ int s_warp[32];
  __shared__ int s_base;
  const int b = blockIdx.y, t = blockIdx.x;
  if (valid[static_cast<long long>(b) * valid_stride] == 0) return;  // pass 2: identity rows
  const int32_t* row = cbits + static_cast<long long>(b) * E;
  const long long e0 = static_cast<long long>(t) * kTile + threadIdx.x * kScanPer;
  int32_t key[kScanPer];
  if (E % 4 == 0 && e0 + kScanPer <= E) {  // rows 16-byte aligned: four 16-byte loads
#pragma unroll
    for (int q = 0; q < kScanPer / 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + e0) + q);
      key[4 * q] = v.x;
      key[4 * q + 1] = v.y;
      key[4 * q + 2] = v.z;
      key[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) key[q] = e0 + q < E ? __ldg(row + e0 + q) : kBig;
  }
  int32_t mn = key[0];
#pragma unroll
  for (int q = 1; q < kScanPer; ++q) mn = min(mn, key[q]);
  mn = block_min<kScanThreads>(mn, s_warp);
  const uint32_t lim = thresholds(mn, beam, lattice_beam).range;
  int n = 0;
#pragma unroll
  for (int q = 0; q < kScanPer; ++q) n += ukey(key[q]) <= lim;
  int total;
  int p = block_excl_scan<kScanThreads>(n, s_warp, &total);
  if (threadIdx.x == 0) {
    if (mn < kBig) atomicMin(best + b, mn);
    s_base = total ? atomicAdd(count + b, total) : 0;
  }
  __syncthreads();
  uint64_t* out = list + static_cast<long long>(b) * E + s_base;
#pragma unroll
  for (int q = 0; q < kScanPer; ++q)
    if (ukey(key[q]) <= lim)
      out[p++] = (static_cast<uint64_t>(ukey(key[q])) << 32) | static_cast<uint32_t>(e0 + q);
}

// Pass 2, one block per channel: everything else.
//  1. the channel's best key from pass 1, and its thresholds;
//  2. the in-range candidates from the channel's list; if more than the
//     sort holds, radix selects find the key at rank N = max(R, K2) and,
//     where its run straddles the cut, the e at the run's rank, and the
//     list keeps the N first in (key, e) order: every key below the cut,
//     and the lowest e among the equal keys at it;
//  3. sort them by (key, e): rank i is pool position i, so the lattice
//     rows are ranks [0, R) and the dedup set ranks [0, K2);
//  4. the dedup set's candidates within the beam, keyed (next state,
//     rank), sorted: the first of each state is its winner;
//  5. the winners keyed (key, position p in state order), sorted: slot
//     j of the new frontier is the j-th, which is the source's (cbits, n)
//     order, all of them within the beam;
//  6. write the frontier and the frontier records, the worst finite kept
//     cost wk, then the lattice rows against wk + lattice_beam.
// kGlobal = false (N <= kCap, max-active up to 8,192): the sort keys x
// and the e of each rank y live in shared memory, the winners overwrite
// x and carry their rank in the key's low kRankBits.  kGlobal = true
// (larger N): x [sort_size(N)], y [N] and the winners w [sort_size(K2)]
// are the channel's rows of global scratch (in L2 at these sizes); a
// winner's rank is read back from x at p, which stays intact.
// In-place compactions run in rounds of one element per thread: a round
// writes only below the elements it has read, and reads are done before
// the scan that places the writes.
template <bool kGlobal>
__global__ void __launch_bounds__(kRankThreads, 1)
select_v4_rank_kernel(const int32_t* __restrict__ cbits, const int32_t* __restrict__ nsm,
                      const int32_t* __restrict__ pm, long long E, int32_t* __restrict__ chan_best,
                      int32_t* __restrict__ chan_count, const uint64_t* __restrict__ list,
                      const int32_t* __restrict__ tok_state, const float* __restrict__ tok_cost,
                      const int32_t* __restrict__ tok_tsil, const uint8_t* __restrict__ valid,
                      long long valid_stride, float beam, float lattice_beam, int K, int K2,
                      int R, int S, int mbits, int32_t* __restrict__ new_state,
                      float* __restrict__ new_cost, int32_t* __restrict__ new_tsil,
                      int32_t* __restrict__ rec_pm, int32_t* __restrict__ rec_state,
                      float* __restrict__ rec_fcost, int32_t* __restrict__ rec_lat_pm,
                      float* __restrict__ rec_lat_cost, uint64_t* glob_x, uint32_t* glob_y,
                      uint64_t* glob_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[32];
  __shared__ int s_int[4];
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long bK = static_cast<long long>(b) * K, bR = static_cast<long long>(b) * R;
  const long long bE = static_cast<long long>(b) * E;
  const int K2e = static_cast<int>(min(static_cast<long long>(K2), E));
  const int N = max(R, K2e);
  const int cap = kGlobal ? sort_size(N) : kCap;
  // x: sort keys; y: e of rank i; w: the winners; hist: the cuts' digits
  uint64_t* x = kGlobal ? glob_x + static_cast<long long>(b) * cap
                        : reinterpret_cast<uint64_t*>(smem);
  uint32_t* y = kGlobal ? glob_y + static_cast<long long>(b) * N
                        : reinterpret_cast<uint32_t*>(smem + kCap * 8);
  uint64_t* w_keys = kGlobal ? glob_w + static_cast<long long>(b) * sort_size(K2e) : x;
  int* hist = kGlobal ? reinterpret_cast<int*>(smem) : reinterpret_cast<int*>(y);
  if (valid[static_cast<long long>(b) * valid_stride] == 0) {
    // a masked frame: the old frontier, identity records
    for (int j = tid; j < max(K, R); j += kRankThreads) {
      const int32_t ident = kPmIdent | (j << mbits);
      if (j < K) {
        const int32_t fs = tok_state[bK + j];
        const float fc = tok_cost[bK + j];
        new_state[bK + j] = fs;
        new_cost[bK + j] = fc;
        new_tsil[bK + j] = tok_tsil[bK + j];
        rec_pm[bK + j] = ident;
        rec_state[bK + j] = fs;
        rec_fcost[bK + j] = fc;
      }
      if (j < R) {
        rec_lat_pm[bR + j] = j < K ? ident : -1;
        rec_lat_cost[bR + j] = j < K ? tok_cost[bK + j] : INFINITY;
      }
    }
    return;
  }

  // 1. the best key and the thresholds; pass 1's counters reset for the
  // next call once every thread has read them
  const int32_t best = chan_best[b];
  const int n_super = chan_count[b];
  if (tid == 0) s_int[3] = 0;
  __syncthreads();
  if (tid == 0) {
    chan_best[b] = kBig;
    chan_count[b] = 0;
  }
  const Thresholds th = thresholds(best, beam, lattice_beam);
  const uint64_t* chan_list = list + bE;
  constexpr int kPer = 8;  // list entries per thread per chunk
  constexpr int kChunk = kRankThreads * kPer;
  // entry q of this thread in the chunk at `base`, or kNone
  auto entry = [&](int base, int q) -> uint64_t {
    const int g = base + q * kRankThreads + tid;
    return g < n_super ? chan_list[g] : kNone;
  };

  // 2. the in-range candidates (the first cap of them kept; their order
  // does not matter, the sorts below give it)
  for (int base = 0; base < n_super; base += kChunk) {
    uint64_t v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) v[q] = entry(base, q);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const bool in = static_cast<uint32_t>(v[q] >> 32) <= th.range;
      const int p = warp_append(in, &s_int[3]);
      if (in && p < cap) x[p] = v[q];
    }
  }
  __syncthreads();
  const int n_in = s_int[3];
  int n_a = n_in;
  if (n_in > cap) {
    // keep the N first by (key, e): radix selects, over the list, of the
    // key at rank N - 1 and, where that key's run straddles the cut, of
    // the e at the run's rank; digits of up to 11 bits from the top set
    // bit of the field's range (keys as offsets from the best key)
    auto radix = [&](auto field, auto keep, int top, int& k0, int& n_eq) -> uint32_t {
      uint32_t prefix = 0;
      for (; top > 0; top -= kHistBits) {
        const int nbits = min(kHistBits, top), shift = top - nbits, bins = 1 << nbits;
        for (int i = tid; i < bins; i += kRankThreads) hist[i] = 0;
        __syncthreads();
        for (int base = 0; base < n_super; base += kChunk) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const uint64_t v = entry(base, q);
            const uint32_t f = field(v);
            const bool in = keep(v) && (static_cast<uint64_t>(f) >> top) ==
                                           (static_cast<uint64_t>(prefix) >> top);
            const int bin = in ? static_cast<int>((f >> shift) & (bins - 1)) : -1;
            // one atomic per bin per warp: in-range keys share their top digits
            const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
            if (in && (tid & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
          }
        }
        __syncthreads();
        const int per = (bins + kRankThreads - 1) / kRankThreads;
        const int d0 = min(tid * per, bins), d1 = min(d0 + per, bins);
        int c = 0;
        for (int d = d0; d < d1; ++d) c += hist[d];
        int tot;
        int acc = block_excl_scan<kRankThreads>(c, s_warp, &tot);
        if (acc <= k0 && k0 < acc + c) {
          for (int d = d0; d < d1; ++d) {
            const int h = hist[d];
            if (k0 < acc + h) {
              s_int[0] = d;
              s_int[1] = k0 - acc;
              s_int[2] = h;
              break;
            }
            acc += h;
          }
        }
        __syncthreads();
        prefix |= static_cast<uint32_t>(s_int[0]) << shift;
        k0 = s_int[1];
        n_eq = s_int[2];
        __syncthreads();
      }
      return prefix;
    };
    const uint32_t base_u = ukey(best);
    int k0 = N - 1, n_eq = 0;
    const uint32_t t_key =
        base_u + radix([&](uint64_t v) { return static_cast<uint32_t>(v >> 32) - base_u; },
                       [&](uint64_t v) { return static_cast<uint32_t>(v >> 32) <= th.range; },
                       32 - __clz((th.range - base_u) | 1u), k0, n_eq);
    uint32_t e_cut = 0xFFFFFFFFu;  // all n_eq entries at the cut key, unless
    if (n_eq > k0 + 1)              // only the k0 + 1 of lowest e
      e_cut = radix([&](uint64_t v) { return static_cast<uint32_t>(v); },
                    [&](uint64_t v) { return static_cast<uint32_t>(v >> 32) == t_key; },
                    32 - __clz(static_cast<uint32_t>(E - 1) | 1u), k0, n_eq);
    if (tid == 0) s_int[3] = 0;
    __syncthreads();
    for (int base = 0; base < n_super; base += kChunk) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const uint64_t v = entry(base, q);
        const uint32_t u = static_cast<uint32_t>(v >> 32);
        const bool take = u < t_key || (u == t_key && static_cast<uint32_t>(v) <= e_cut);
        const int p = warp_append(take, &s_int[3]);
        if (take) x[p] = v;
      }
    }
    n_a = N;
  }

  // 3. rank i = pool position i
  __syncthreads();
  pad_and_sort(x, n_a);
  const int n_r = min(n_a, N);
  const int n_d = min(n_r, K2e);

  // 4. y[i] = e of rank i; the dedup set's in-beam candidates -> (state, rank)
  int n_w = 0;
  for (int r0 = 0; r0 < n_r; r0 += kRankThreads) {
    const int i = r0 + tid;
    uint64_t w = kNone;
    if (i < n_r) {
      const uint64_t c = x[sw(i)];
      const uint32_t e = static_cast<uint32_t>(c);
      y[i] = e;
      if (i < n_d && key_of(c) <= th.keep) {
        const int32_t n = nsm[bE + e];
        if (n != S) w = (static_cast<uint64_t>(static_cast<uint32_t>(n)) << 32) | i;
      }
    }
    int tot;
    const int p = n_w + block_excl_scan<kRankThreads>(w != kNone, s_warp, &tot);
    if (w != kNone) x[p] = w;
    n_w += tot;
  }
  __syncthreads();
  pad_and_sort(x, n_w);

  // 5. the first of each state wins; winners -> (key, state position p)
  // (shared: the winners overwrite x, so where states start is read
  // first, and each carries its rank; global: x stays)
  unsigned first = 0;  // bit q: entry tid + q * kRankThreads starts a state
  auto starts = [&](int p) {
    return p < n_w && (p == 0 || (x[sw(p)] >> 32) != (x[sw(p - 1)] >> 32));
  };
  if (!kGlobal) {
    for (int q = 0; q * kRankThreads < n_w; ++q)
      if (starts(q * kRankThreads + tid)) first |= 1u << q;
    __syncthreads();
  }
  int n_win = 0;
  for (int q = 0; q * kRankThreads < n_w; ++q) {
    const int p = q * kRankThreads + tid;
    uint64_t w = kNone;
    if (kGlobal ? starts(p) : (first >> q & 1u)) {
      const uint32_t i = static_cast<uint32_t>(x[sw(p)]);
      w = (static_cast<uint64_t>(ukey(cbits[bE + y[i]])) << 32) |
          (kGlobal ? static_cast<uint64_t>(p) : (static_cast<uint64_t>(p) << kRankBits) | i);
    }
    int tot;
    const int at = n_win + block_excl_scan<kRankThreads>(w != kNone, s_warp, &tot);
    if (w != kNone) w_keys[at] = w;
    n_win += tot;
  }
  __syncthreads();
  pad_and_sort(w_keys, n_win);

  // 6. the frontier, its records, wk; then the lattice rows
  if (tid == 0) s_int[2] = kNoKey;
  __syncthreads();
  for (int j = tid; j < K; j += kRankThreads) {
    int32_t fs = S, ft = 0, rp = -1;
    float fc = INFINITY;
    if (j < n_win) {
      const uint64_t c = w_keys[sw(j)];
      const uint32_t e = y[kGlobal ? static_cast<uint32_t>(x[sw(static_cast<uint32_t>(c))])
                                   : c & ((1u << kRankBits) - 1)];
    const int32_t key = key_of(c);
      const int32_t p = pm[bE + e];
      const int prev = static_cast<int>(static_cast<uint32_t>(p & kPmMask) >> mbits);
      const int32_t pts = prev < K ? __ldg(tok_tsil + bK + prev) : 0;
      fs = nsm[bE + e];
      fc = key_cost(key);
      ft = (p & kPmSil) ? (((pts & kTsilMask) + 1) | (pts & kSpeech)) : kSpeech;
      rp = p & kPmMask;
      if (key > -kPosInfKey && key < kPosInfKey) atomicMax(&s_int[2], key);
    }
    new_state[bK + j] = fs;
    new_cost[bK + j] = fc;
    new_tsil[bK + j] = ft;
    rec_pm[bK + j] = rp;
    rec_state[bK + j] = fs;
    rec_fcost[bK + j] = fc;
  }
  __syncthreads();
  const float wk = s_int[2] == kNoKey ? -INFINITY : key_cost(s_int[2]);
  const float lat_lim = __fadd_rn(wk, lattice_beam);
  for (int j = tid; j < R; j += kRankThreads) {
    int32_t lp = -1;
    float lc = INFINITY;
    if (j < n_r) {
      const uint32_t e = y[j];
      const int32_t key = cbits[bE + e];
      const float c = key_cost(key);
      if (c <= lat_lim) {  // every ranked key is below BIG
        lp = pm[bE + e] & kPmMask;
        lc = c;
      }
    }
    rec_lat_pm[bR + j] = lp;
    rec_lat_cost[bR + j] = lc;
  }
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

template <bool kVec4, bool kStaged>
cudaError_t launch_expand(dim3 grid, cudaStream_t s, const int32_t* em_pack,
                          const int32_t* tok_state, const float* tok_cost, const float* ll,
                          long long ll_stride, int n_stage, float neg_scale, int K, int S,
                          int M, int mbits, int32_t* cbits, int32_t* nsm, int32_t* pm) {
  const size_t smem = kStaged ? static_cast<size_t>(n_stage) * 4 : 0;
  if (smem > kStaticSmemLimit) {
    static std::atomic<bool> smem_allowed[kMaxDevices];
    const cudaError_t err = allow_smem(expand_v4_kernel<kVec4, kStaged>, kPdfWords * 4,
                                       smem_allowed);
    if (err != cudaSuccess) return err;
  }
  expand_v4_kernel<kVec4, kStaged><<<grid, kThreads, smem, s>>>(
      em_pack, tok_state, tok_cost, ll, ll_stride, n_stage, neg_scale, K, S, M, mbits, cbits,
      nsm, pm);
  return cudaGetLastError();
}

// The current device's SM count (the runtime answers from its own cache).
int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

}  // namespace

// stage_req: -1 picks as below, 0 asks for the staged row, 1 for reads in
// place (a row the bulk copy cannot take is always read in place).
extern "C" int vt_expand_v4(const void* em_pack, const void* tok_state, const void* tok_cost,
                            const void* ll, long long ll_stride, int P, float scale, int B,
                            int K, int S, int M, int mbits, void* cbits, void* nsm, void* pm,
                            int stage_req, void* stream) {
  const int n_stage = P < kPdfWords ? P : kPdfWords;
  const bool vec4 = M == 4;
  const long long units = vec4 ? K : static_cast<long long>(K) * M;
  const dim3 grid(static_cast<unsigned>((units + kThreads - 1) / kThreads), B);
  // Staging pays while every block has an SM, and its L1, to itself: one
  // bulk copy brings the row, overlapped with the token loads.  With more
  // blocks than SMs, blocks of a channel share an SM's L1, and reads in
  // place hit the lines the others brought, where staging would repeat the
  // whole row per block.  The bulk copy needs a 16-byte aligned source and
  // a multiple of 16 bytes.
  const bool aligned = reinterpret_cast<uintptr_t>(ll) % 16 == 0 && ll_stride % 4 == 0 &&
                       n_stage % 4 == 0;
  const bool staged = aligned && (stage_req < 0
                                      ? static_cast<long long>(grid.x) * B <= num_sms()
                                      : stage_req == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const int32_t*>(em_pack);
  const auto* ts = static_cast<const int32_t*>(tok_state);
  const auto* tc = static_cast<const float*>(tok_cost);
  const auto* l = static_cast<const float*>(ll);
  auto* c = static_cast<int32_t*>(cbits);
  auto* n = static_cast<int32_t*>(nsm);
  auto* p = static_cast<int32_t*>(pm);
  const float neg = -scale;
#define VT_EXPAND(VEC4, STAGED)                                                               \
  launch_expand<VEC4, STAGED>(grid, s, e, ts, tc, l, ll_stride, n_stage, neg, K, S, M, mbits, \
                              c, n, p)
  const cudaError_t err = vec4 ? (staged ? VT_EXPAND(true, true) : VT_EXPAND(true, false))
                               : (staged ? VT_EXPAND(false, true) : VT_EXPAND(false, false));
#undef VT_EXPAND
  return static_cast<int>(err);
}

extern "C" int vt_select_v4(
    const void* cbits, const void* nsm, const void* pm, long long E, const void* tok_state,
    const void* tok_cost, const void* tok_tsil, const void* valid, long long valid_stride,
    float beam, float lattice_beam, int B, int K, int K2, int R, int S, int mbits,
    void* chan_best, void* chan_count, void* list, void* new_state, void* new_cost,
    void* new_tsil, void* rec_pm, void* rec_state, void* rec_fcost, void* rec_lat_pm,
    void* rec_lat_cost, void* glob_x, void* glob_y, void* glob_w, void* stream) {
  const long long n_tiles = (E + kTile - 1) / kTile;
  if (B <= 0 || n_tiles <= 0 || n_tiles > 0x7FFFFFFF || K2 <= 0 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cb = static_cast<const int32_t*>(cbits);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* best = static_cast<int32_t*>(chan_best);
  auto* count = static_cast<int32_t*>(chan_count);
  auto* l = static_cast<uint64_t*>(list);
  select_v4_scan_kernel<<<dim3(static_cast<unsigned>(n_tiles), B), kScanThreads, 0, s>>>(
      cb, E, v, valid_stride, beam, lattice_beam, best, count, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int K2e = K2 < E ? K2 : static_cast<int>(E);
  const bool global = (R > K2e ? R : K2e) > kCap;
  if (global && (glob_x == nullptr || glob_y == nullptr || glob_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define VT_RANK(GLOBAL, SMEM)                                                                  \
  select_v4_rank_kernel<GLOBAL><<<B, kRankThreads, SMEM, s>>>(                                 \
      cb, static_cast<const int32_t*>(nsm), static_cast<const int32_t*>(pm), E, best, count, l, \
      static_cast<const int32_t*>(tok_state), static_cast<const float*>(tok_cost),             \
      static_cast<const int32_t*>(tok_tsil), v, valid_stride, beam, lattice_beam, K, K2, R, S, \
      mbits, static_cast<int32_t*>(new_state), static_cast<float*>(new_cost),                  \
      static_cast<int32_t*>(new_tsil), static_cast<int32_t*>(rec_pm),                          \
      static_cast<int32_t*>(rec_state), static_cast<float*>(rec_fcost),                        \
      static_cast<int32_t*>(rec_lat_pm), static_cast<float*>(rec_lat_cost),                    \
      static_cast<uint64_t*>(glob_x), static_cast<uint32_t*>(glob_y),                          \
      static_cast<uint64_t*>(glob_w))
  if (global) {
    VT_RANK(true, kHistSmem);
  } else {
    static std::atomic<bool> smem_allowed[kMaxDevices];
    err = allow_smem(select_v4_rank_kernel<false>, static_cast<int>(kRankSmem), smem_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    VT_RANK(false, kRankSmem);
  }
#undef VT_RANK
  return static_cast<int>(cudaGetLastError());
}
