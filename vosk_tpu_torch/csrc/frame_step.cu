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
// and one fused multiply-add per element.  What it must move: the token
// words, the live tokens' arc rows and the ll words they reach, the key of
// every candidate (4 bytes) and the next state and pm word of each real
// arc of a live token (8 bytes): about 5.2 MB per frame at B = 32, K =
// 7000, M = 4 with 10,048 live tokens, about 12 MB with every token live.
// Select needs only the pool's keys (4 bytes a candidate, 3.6 MB at B =
// 32), the payload of the candidates within reach of the beams and its
// outputs, but its time is latency: a chain of dependent steps per channel
// (cuts, dedup, sorts), and at B = 1 the two launches and that chain are
// all of it (PERF.md).  The source's three stable sorts of the whole pool
// and their payload gathers moved many times the bytes, in about a dozen
// launches.
//
// The pool's contract: cbits holds every candidate's key; nsm and pm are
// defined where cbits < BIG.  Select never reads the payload of a BIG key
// (pass 1's range stops below BIG, and pass 2 sees only the list), so
// expand leaves it unwritten: a dead token's candidates and padding arcs
// (w = +inf) cost 4 bytes, not 12.  A real arc whose cost is +inf (a -inf
// score) is keyed 0x7F800000, below BIG, and carries its payload.
//
// What the design does about it:
//  * one pass each: the indices of the old gather never reach device
//    memory, and no [B, K*M] intermediate is written between the arc-row
//    read and the cost keys;
//  * grids of (element tiles, B), so B = 32 gives ~900 blocks of 256
//    threads (the old gather ran 7 or 2 blocks per channel);
//  * expand reads the channel's ll row one of two ways (stage_req; the
//    kernel's own choice is by shape, from the card's times, PERF.md):
//     - staged: one thread of each block starts a 1-D bulk copy (TMA,
//       cp.async.bulk) of the row into shared memory at block start,
//       completing on an mbarrier; the block loads its tokens' states,
//       costs and arc rows while the copy is in flight and waits only
//       before the lookups (csrc/stage.cuh).  It pays only while every
//       block has an SM to itself and the channel spans many blocks (B = 1
//       over the whole frontier);
//     - in place, through the read-only path: with more blocks than SMs,
//       blocks of a channel share an SM's L1, and each lookup reads only
//       its sector.
//    The row multicast over a thread-block cluster of a channel's tiles
//    (stage.cuh, as the gather kernel uses it) was measured and left out:
//    it won only on a frame with every token live (by 2 %), whose shape is
//    the light frame's, where it lost by 41 % (PERF.md, PR 15).  The words
//    a lookup can reach are staged: min(P, 2^14) for packed16 rows (pdf
//    ids below 2^14), all P for exact3 rows, up to the block's opt-in
//    shared memory (227 KB on H100, P up to about 58,000).  A pdf >= P
//    reads 0 either way, as the source's onehot_gather gives it.  A row
//    whose start or length is not a multiple of 16 bytes, which the bulk
//    copy cannot take, is read in place;
//  * expand reads either row layout, a template parameter: packed16 rows
//    [S+1, 2M] (f16 weight, sil and a 14-bit pdf in one word, then the
//    next state) or exact3 rows [S+1, 3M] (f32 weight bits, next state,
//    meta = sil << pdf_bits | pdf, for pdf ids of 15 bits or more, the
//    source's v4 step on exact3 rows);
//  * expand at M = 4: one thread per token reads its 32-byte packed16 row
//    as two 16-byte loads (an exact3 row: 48 bytes, three loads) and
//    writes its four keys as one 16-byte store, and its four next states
//    and pm words as two more where any of its arcs is real; other M: four
//    candidates a thread, all their loads issued before the first lookup;
//  * expand: a dead token (state S) reads no row and writes only BIG keys:
//    row S is all padding (w = +inf, next = S, sil = 0);
//  * expand over a stripe, for the sharded search (the source's
//    _frame_step_v4_sharded, :1494-1517): a launch takes the frontier's
//    slots base, base + stride, ... and reads their state and cost words in
//    place from the whole [B, K] frontier (strided 4-byte loads, a small
//    share of the arc-row bytes), so no strided copy of the frontier is
//    made, and pm carries the global slot;
//  * select follows what it computes, not the source's sorts.  Per channel,
//    over the 64-bit order (cost key, e): D, the K2 smallest, is a set;
//    each next state's winner is its smallest member of D; the winners
//    ranked by (cost key, state) fill the frontier within the beam from
//    the best one; the lattice rows are L, the R smallest, in order.  Only
//    candidates within best + beam can become kept winners, and only those
//    within (best + beam) + lattice_beam kept lattice rows (f32 addition is
//    monotone; best, the pool's smallest key, always wins its state);
//  * select pass 1 (grid of 4096-candidate tiles x B) reads each key once,
//    folds the channel's minimum in with atomicMin, and appends the numbers
//    e of the candidates within the range that the smaller of its tile's
//    minimum and the channel's minimum so far gives (a superset of the
//    channel's) to one int32 list per channel; the padding slots of wide
//    rows (1.86 M candidates a frame on a split graph) never leave their
//    tile;
//  * select pass 2 runs a thread-block cluster per channel, launched with
//    cudaLaunchKernelEx: C CTAs of 1024 threads, the most (up to 8) with
//    which the card holds all B clusters at once
//    (cudaOccupancyMaxActiveClusters; on H100: 8 at B = 1, 3 at B = 32),
//    but no more than the pool has 4,096-candidate tiles, and at least 2.
//    The CTAs split every walk of the list and of the table and meet at
//    cluster barriers; through distributed shared memory they sum each
//    other's histograms, share one hash table and fill each other's
//    buckets:
//     - the cuts D and L by radix select, only where the list is longer
//       than min(K2, R) (or than 2,048, for the buckets): rounds of 11-bit
//       digits of the key's offset from the best key (the in-range keys
//       span few bits), then, where the run of equal keys at a cut
//       straddles it, of e, so ties go to the lowest e as the source's
//       stable sort gives them; one walk a round serves both cuts; the
//       first also counts what is in range and keeps each CTA's in-range
//       entries in its shared memory for the later walks;
//     - the dedup without a sort: D's candidates within the beam whose next
//       state is not S go into an open-addressing table keyed by state
//       (5/4 of K2 slots, CTA r holding a contiguous share, linear
//       probing), its value the smallest (key << 32 | e); its entries are
//       the winners.  On a long list each candidate is first sent to the
//       inbox of the CTA that holds its state's home slot, which inserts
//       it with its own shared-memory atomics: a 64-bit atomic minimum
//       into another CTA's memory loses updates on H100, and a remote
//       compare-and-swap loop costs several round trips;
//     - the winners ranked by (key, state): where a cut at K is needed, by
//       radix select as above, or, on a long list whose buckets hold them
//       all, none: every winner is ranked and the ranks past K dropped;
//     - ranking without a global sort: on a long list, L and W are split
//       into C buckets by ranges of the first digit, chosen from its
//       histogram so that each holds about 1 / C of them, one bucket per
//       CTA; a short one keeps W in rank 0 and L in rank 1.  A CTA ranks
//       its bucket by a counting sort on the first digit and a count
//       within each digit's group (a few keys under load), or, where a
//       group holds more than 128, by sorting tiles of 256 keys in a
//       warp's registers and a binary search per tile; each row is written
//       at the bucket's offset plus its rank: the frontier and its records
//       (e by a table lookup, then pm and the old tsil[prev]), the lattice
//       rows as if kept, then, once the cluster's worst finite kept cost
//       wk is known, those above wk + lattice_beam dropped;
//     - buckets of up to 8,192 keys and tables of up to 20,480 slots
//       (max-active up to 8,192) live in shared memory; larger ones in
//       per-channel rows of global scratch, with the same code.
// Pass 2 resets pass 1's per-channel minimum and count for the next call
// once every CTA has read them; the wrapper sets them once, at allocation.
// The shared-memory opt-in of a kernel is set once per device.

// Bit parity with the JAX decoder on the CPU: the cost is
// fma(-scale, ac, tok_cost + w) with both roundings explicit (XLA contracts
// the source's expression the same way; no plain * or + that nvcc could
// contract); the f16 weight is converted with __half2float (an exact3
// weight is read as its f32 bits); cost keys use
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

#include <algorithm>
#include <atomic>

#include <cooperative_groups.h>

#include "stage.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCandPer = 4;                    // candidates a thread of expand's any-M path
constexpr int kScanThreads = 256;             // select_v4 pass 1
constexpr int kScanPer = 16;                   // candidates per pass-1 thread
constexpr int kTile = kScanThreads * kScanPer;  // candidates per pass-1 block
constexpr int kSelThreads = 1024;             // select_v4 pass 2: threads of each CTA
constexpr int kMaxCluster = 8;                 // CTAs of a channel's cluster, at most
constexpr int kSortCap = 8192;                 // keys a bucket holds in shared memory
constexpr int kTableCap = 20480;               // hash slots a cluster holds in shared memory
constexpr int kMinSlots = 1024;                // hash slots of a channel, at least
constexpr int kHeavyList = 2048;               // list length from which the sorts take buckets
constexpr int kHistBits = 11;                  // radix digit of the cuts
constexpr int kBins = 1 << kHistBits;
constexpr size_t kHistBytes = static_cast<size_t>(4) * kBins * 4;  // [parity][target][bin]
constexpr int kWalkPer = 4;                    // list entries per thread per step of a walk
constexpr int kInbox = static_cast<int>(kHistBytes / 8);  // entries of a CTA's table inbox
constexpr int kGroup = 128;                    // keys of one first digit ranked by counting
static_assert(kBins == 2 * kSelThreads, "cut_advance sums two bins a thread");
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

// Pass 2's dynamic shared memory: the histograms, then (shared-memory
// variant) this CTA's table slots (values, keys) and its bucket of cap keys,
// then a cache of its in-range list entries (whatever room is left).
struct SelectSmem {
  size_t tv, tk, buf, cache;
};

__host__ __device__ inline SelectSmem select_smem(int per, int cap, bool global) {
  SelectSmem m;
  m.tv = kHistBytes;
  m.tk = m.tv + static_cast<size_t>(per) * 8;
  m.buf = (m.tk + static_cast<size_t>(per) * 4 + 15) & ~static_cast<size_t>(15);
  m.cache = global ? kHistBytes : m.buf + static_cast<size_t>(cap) * 8;
  return m;
}

__device__ __forceinline__ int32_t cost_key(float c) {
  const int32_t b = __float_as_int(c);
  return b < 0 ? static_cast<int32_t>(0x80000000u - static_cast<uint32_t>(b)) : b;
}

__device__ __forceinline__ float key_cost(int32_t k) {
  return __int_as_float(
      k < 0 ? static_cast<int32_t>(0x80000000u - static_cast<uint32_t>(k)) : k);
}

using vt_stage::allow_smem;
using vt_stage::cluster_config;
using vt_stage::kMaxDevices;
using vt_stage::kStageReserve;
using vt_stage::kStaticSmemLimit;
using vt_stage::num_sms;
using vt_stage::stage_begin;
using vt_stage::stage_smem_limit;
using vt_stage::stage_wait;

// One candidate of a live token: (cost key, next state, pm word).  p1 is
// the packed16 word (kPlanes 2; meta unused), or the exact3 f32 weight bits
// with meta = sil << pdf_bits | pdf (kPlanes 3).  row is the ll row in
// shared memory when kStaged, else in global memory; n_ll words of it are
// readable (a pdf at or above reads 0).  A padding arc (w = +inf) gets the
// key BIG; its ns and pm are then not stored.
template <int kPlanes, bool kStaged>
__device__ __forceinline__ void score(int32_t p1, int32_t nsf, int32_t meta, float tok_cost,
                                      const float* row, int n_ll, int pdf_bits,
                                      float neg_scale, int32_t prevm, int32_t& cb, int32_t& ns,
                                      int32_t& pm) {
  float w;
  int32_t sil;
  int pdf;
  if (kPlanes == 2) {
    const uint32_t u = static_cast<uint32_t>(p1);
    w = __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
    sil = static_cast<int32_t>((u >> 14) & 1u);
    pdf = static_cast<int>(u & 0x3FFFu);
  } else {
    const uint32_t u = static_cast<uint32_t>(meta);
    w = __int_as_float(p1);
    sil = static_cast<int32_t>((u >> pdf_bits) & 1u);
    pdf = static_cast<int>(u & ((1u << pdf_bits) - 1u));
  }
  pm = prevm + (sil << 30);
  ns = nsf & kNsMask;
  cb = kBig;
  if (isfinite(w)) {
    const float ac = pdf < n_ll ? (kStaged ? row[pdf] : __ldg(row + pdf)) : 0.0f;
    cb = cost_key(__fmaf_rn(neg_scale, ac, __fadd_rn(tok_cost, w)));
  }
}

// The tokens a launch expands: token k of channel b is the frontier's slot
// base + k * stride, read in place at tok_state[b * row + slot] (row: the
// frontier's row length).  The whole frontier is (row K, base 0, stride 1);
// a rank of the sharded search takes the stripe (base i, stride n), and
// pm carries the global slot (source _expand_v4 :884-893).
struct Stripe {
  long long row;
  int base;
  int stride;
};

// kStaged: the ll row comes into shared memory by a bulk copy.  Writes
// the key of every candidate; nsm and pm only where the key is below BIG.
template <int kPlanes, bool kVec4, bool kStaged>
__global__ void __launch_bounds__(kThreads)
expand_v4_kernel(const int32_t* __restrict__ em_pack, const int32_t* __restrict__ tok_state,
                 const float* __restrict__ tok_cost, const float* __restrict__ ll,
                 long long ll_stride, int n_ll, int pdf_bits, float neg_scale, int K,
                 Stripe stripe, int S, int M, int mbits, int32_t* __restrict__ cbits,
                 int32_t* __restrict__ nsm, int32_t* __restrict__ pm) {
  extern __shared__ __align__(16) float smem_row[];
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.y;
  const float* ll_row = ll + static_cast<long long>(b) * ll_stride;
  if (kStaged) stage_begin(smem_row, &bar, ll_row, n_ll);
  const float* row = kStaged ? smem_row : ll_row;
  const long long E = static_cast<long long>(K) * M;
  if (kVec4) {  // M == 4: one thread per token
    const int k = blockIdx.x * kThreads + threadIdx.x;
    const bool in = k < K;
    const int slot = stripe.base + k * stripe.stride;  // the token's global slot
    const long long tok = static_cast<long long>(b) * stripe.row + slot;
    const int s = in ? tok_state[tok] : S;
    float tc = 0.0f;
    int4 p1 = make_int4(0, 0, 0, 0), nx = p1, mt = p1;
    if (s != S) {
      tc = tok_cost[tok];
      const int4* r =
          reinterpret_cast<const int4*>(em_pack + static_cast<long long>(s) * (4 * kPlanes));
      p1 = __ldg(r);
      nx = __ldg(r + 1);
      if (kPlanes == 3) mt = __ldg(r + 2);
    }
    if (kStaged) stage_wait(&bar, n_ll);
    if (!in) return;
    const int32_t pm0 = slot << mbits;
    int4 oc = make_int4(kBig, kBig, kBig, kBig), on = p1, op = p1;
    if (s != S) {  // a dead token (state S) has no arc: row S is all padding
      score<kPlanes, kStaged>(p1.x, nx.x, mt.x, tc, row, n_ll, pdf_bits, neg_scale, pm0, oc.x,
                              on.x, op.x);
      score<kPlanes, kStaged>(p1.y, nx.y, mt.y, tc, row, n_ll, pdf_bits, neg_scale, pm0 | 1,
                              oc.y, on.y, op.y);
      score<kPlanes, kStaged>(p1.z, nx.z, mt.z, tc, row, n_ll, pdf_bits, neg_scale, pm0 | 2,
                              oc.z, on.z, op.z);
      score<kPlanes, kStaged>(p1.w, nx.w, mt.w, tc, row, n_ll, pdf_bits, neg_scale, pm0 | 3,
                              oc.w, on.w, op.w);
    }
    const long long e0 = static_cast<long long>(b) * E + 4LL * k;
    *reinterpret_cast<int4*>(cbits + e0) = oc;
    if (oc.x != kBig || oc.y != kBig || oc.z != kBig || oc.w != kBig) {  // a real arc
      *reinterpret_cast<int4*>(nsm + e0) = on;
      *reinterpret_cast<int4*>(pm + e0) = op;
    }
  } else {  // any M: kCandPer candidates a thread, e = k*M + m (E < 2^31)
    // each thread's candidates lie kThreads apart (coalesced), and every
    // load is issued before the first lookup: a wide-row frame (1.86 M
    // candidates at M = 266) is then a few waves of blocks, not dozens of
    // waves each waiting out the state -> row chain
    const long long e0 = static_cast<long long>(blockIdx.x) * kThreads * kCandPer + threadIdx.x;
    int s[kCandPer], m[kCandPer], slot[kCandPer];
    float tc[kCandPer];
    int32_t p1[kCandPer], nx[kCandPer], mt[kCandPer];
#pragma unroll
    for (int i = 0; i < kCandPer; ++i) {
      const long long ee = e0 + static_cast<long long>(i) * kThreads;
      const int e = ee < E ? static_cast<int>(ee) : 0;
      const int k = e / M;
      m[i] = e - k * M;
      slot[i] = stripe.base + k * stripe.stride;
      s[i] = ee < E ? tok_state[static_cast<long long>(b) * stripe.row + slot[i]] : S;
    }
#pragma unroll
    for (int i = 0; i < kCandPer; ++i) {
      tc[i] = 0.0f;
      p1[i] = nx[i] = mt[i] = 0;
      if (s[i] != S) {
        tc[i] = tok_cost[static_cast<long long>(b) * stripe.row + slot[i]];
        const int32_t* r = em_pack + static_cast<long long>(s[i]) * kPlanes * M;
        p1[i] = __ldg(r + m[i]);
        nx[i] = __ldg(r + M + m[i]);
        if (kPlanes == 3) mt[i] = __ldg(r + 2 * M + m[i]);
      }
    }
    if (kStaged) stage_wait(&bar, n_ll);
#pragma unroll
    for (int i = 0; i < kCandPer; ++i) {
      const long long ee = e0 + static_cast<long long>(i) * kThreads;
      if (ee < E) {
        int32_t oc = kBig, on = 0, op = 0;
        if (s[i] != S)
          score<kPlanes, kStaged>(p1[i], nx[i], mt[i], tc[i], row, n_ll, pdf_bits, neg_scale,
                                  (slot[i] << mbits) | m[i], oc, on, op);
        const long long o = static_cast<long long>(b) * E + ee;
        cbits[o] = oc;
        if (oc != kBig) {
          nsm[o] = on;
          pm[o] = op;
        }
      }
    }
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

// The size of a buffer that ranks n keys: whole tiles of 256.
__host__ __device__ inline int rank_size(int n) { return (n + 255) / 256 * 256; }

// fn(rank, key) for each key of a[0, n), rank its place in ascending order
// (the keys are distinct), without a full sort: each warp sorts tiles of
// 256 keys in its registers (the first eight phases of a bitonic network,
// every tile ascending), then each key's rank is the number of keys below
// it in every tile, one binary search a tile.  a[n, rank_size(n)) is
// overwritten.  Every thread of the block calls it.
template <class F>
__device__ void rank_keys(uint64_t* a, int n, F fn) {
  const int tiles = (n + 255) / 256;
  for (int i = n + threadIdx.x; i < tiles * 256; i += blockDim.x) a[i] = kNone;
  __syncthreads();
  const int warps = static_cast<int>(blockDim.x) / 32, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = warp; t < tiles; t += warps) {
    uint64_t v[8];
    const int g0 = t * 256 + lane * 8;
    tile_load(v, a, g0);
    for (int k = 2; k <= 256; k <<= 1) tile_stages(v, lane * 8, k, k >> 1);
    tile_store(v, a, g0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tiles * 256; i += blockDim.x) {
    const uint64_t x = a[i];  // the tiles' slots in any order; padding skipped
    if (x == kNone) continue;
    int rank = 0;
    for (int t = 0; t < tiles; ++t) {
      const int t0 = t * 256;
      int c = 0;  // keys of tile t below x
#pragma unroll
      for (int step = 128; step > 0; step >>= 1)
        if (a[sw(t0 + c + step - 1)] < x) c += step;
      c += a[sw(t0 + c)] < x;
      rank += c;
    }
    fn(rank, x);
  }
  __syncthreads();
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
// that the smaller of the tile's own minimum and the channel's minimum so
// far gives, appended to the channel's list as candidate numbers e through
// count[b] (pass 2 reads their keys back from cbits).  Both minima are at
// least the channel's best, so the list holds every candidate of the
// channel that is in its range.  Pass 2 resets best[b] and count[b].
__global__ void __launch_bounds__(kScanThreads)
select_v4_scan_kernel(const int32_t* __restrict__ cbits, long long E,
                      const uint8_t* __restrict__ valid, long long valid_stride, float beam,
                      float lattice_beam, int32_t* __restrict__ best, int32_t* __restrict__ count,
                      uint32_t* __restrict__ list) {
  __shared__ int s_warp[32];
  __shared__ int s_base;
  __shared__ int32_t s_best;
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
  if (threadIdx.x == 0) s_best = mn < kBig ? min(mn, atomicMin(best + b, mn)) : mn;
  __syncthreads();
  const uint32_t lim = thresholds(s_best, beam, lattice_beam).range;
  int n = 0;
#pragma unroll
  for (int q = 0; q < kScanPer; ++q) n += ukey(key[q]) <= lim;
  int total;
  int p = block_excl_scan<kScanThreads>(n, s_warp, &total);
  if (threadIdx.x == 0) s_base = total ? atomicAdd(count + b, total) : 0;
  __syncthreads();
  uint32_t* out = list + static_cast<long long>(b) * E + s_base;
#pragma unroll
  for (int q = 0; q < kScanPer; ++q)
    if (ukey(key[q]) <= lim) out[p++] = static_cast<uint32_t>(e0 + q);
}

// A 64-bit load through L2 only: table slots that other CTAs update.
__device__ __forceinline__ uint64_t ld_cg(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

// *p = min(*p, v) for a table value, which may lie in another CTA's shared
// memory.  Hopper's 64-bit atomic minimum loses updates there (measured on
// H100: 256 threads of one CTA into another's word kept a late value, where
// compare-and-swap and the 32-bit minimum kept the least), so the minimum
// is a compare-and-swap loop; it ends once *p is at most v.
__device__ __forceinline__ void atomic_min64(uint64_t* p, uint64_t v) {
  auto* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(q);
  while (v < old) {
    const unsigned long long seen = atomicCAS(q, old, static_cast<unsigned long long>(v));
    if (seen == old) break;
    old = seen;
  }
}

// One order statistic of a channel's items (u, low): u an unsigned cost
// key, low a candidate number e or a next state.  It keeps the items
// (u, low) <= (key, low), the n smallest in that order.  Found digit by
// digit from per-CTA histograms: first the digits of u - base (base the
// channel's best key, so the in-range keys span few bits), then, where the
// run of items at the cut key straddles the cut, the digits of low among
// that run, so ties go to the lowest e (the source's stable sort) or the
// lowest state.
struct Cut {
  int field;        // 0: digits of u - base; 1: digits of low where u == key; 2: found
  int top;          // bits of the field still open
  uint32_t prefix;  // the field's digits fixed so far
  int k0;           // the rank sought among the items that share them
  uint32_t key, low;
};

__device__ __forceinline__ Cut cut_all() { return {2, 0, 0u, 0, 0xFFFFFFFFu, 0xFFFFFFFFu}; }

__device__ __forceinline__ Cut cut_at(int n, int top) { return {0, top, 0u, n - 1, 0u, 0u}; }

__device__ __forceinline__ bool cut_keeps(const Cut& c, uint32_t u, uint32_t low) {
  return u < c.key || (u == c.key && low <= c.low);
}

// The histogram bin of item (u, low) in the cut's next digit, or -1.
__device__ __forceinline__ int cut_bin(const Cut& c, uint32_t u, uint32_t low, uint32_t base) {
  uint32_t f;
  if (c.field == 0)
    f = u - base;
  else if (c.field == 1 && u == c.key)
    f = low;
  else
    return -1;
  if ((static_cast<uint64_t>(f) >> c.top) != (static_cast<uint64_t>(c.prefix) >> c.top)) return -1;
  const int nbits = min(kHistBits, c.top);
  return static_cast<int>((f >> (c.top - nbits)) & ((1u << nbits) - 1u));
}

// Count bin in histogram h (shared memory), unless it is -1.
__device__ __forceinline__ void hist_add(int* h, int bin) {
  if (bin >= 0) atomicAdd(h + bin, 1);
}

// The cluster's sum of histogram h (at the same offset in every CTA's
// shared memory) over `bins` bins: thread t's bins 2t and 2t + 1 into h2,
// and the count in all bins before them returned.  Every thread of the
// block calls it after the barrier that completes h everywhere.
__device__ int hist_sum(cg::cluster_group& cluster, int* h, int bins, int (&h2)[2],
                        int* s_warp) {
  const unsigned C = cluster.num_blocks();
  const int d0 = 2 * static_cast<int>(threadIdx.x);  // kBins = 2 kSelThreads
  h2[0] = h2[1] = 0;
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (d0 + q < bins)
      for (unsigned r = 0; r < C; ++r) h2[q] += cluster.map_shared_rank(h, r)[d0 + q];
  int tot;
  return block_excl_scan<kSelThreads>(h2[0] + h2[1], s_warp, &tot);
}

// The number of bins of the cut's next digit.
__device__ __forceinline__ int cut_bins(const Cut& c) { return 1 << min(kHistBits, c.top); }

// Fix the cut's next digit from the cluster's histogram of it (hist_sum's
// acc and h2).  Every thread of every CTA calls it with the same c and
// histogram, and every CTA reaches the same c.
__device__ void cut_advance(Cut& c, int acc, const int (&h2)[2], uint32_t base, int low_top,
                            int* s_int) {
  const int nbits = min(kHistBits, c.top), shift = c.top - nbits;
  const int d0 = 2 * static_cast<int>(threadIdx.x);
  const int cnt = h2[0] + h2[1];
  if (acc <= c.k0 && c.k0 < acc + cnt) {
    const int q = c.k0 < acc + h2[0] ? 0 : 1;
    s_int[0] = d0 + q;
    s_int[1] = c.k0 - acc - (q ? h2[0] : 0);
    s_int[2] = h2[q];
  }
  __syncthreads();
  const int d = s_int[0], k0 = s_int[1], n_eq = s_int[2];
  __syncthreads();
  c.prefix |= static_cast<uint32_t>(d) << shift;
  c.k0 = k0;
  c.top = shift;
  if (shift == 0) {
    if (c.field == 0) {
      c.key = base + c.prefix;
      if (n_eq > k0 + 1) {  // the run at the cut key straddles it: rank by low
        c.field = 1;
        c.top = low_top;
        c.prefix = 0;
      } else {
        c.field = 2;
        c.low = 0xFFFFFFFFu;
      }
    } else {
      c.low = c.prefix;
      c.field = 2;
    }
  }
}

// Bucket bounds from the cluster's histogram of the first digit (hist_sum's
// acc and h2) over items whose first n in order are to be sorted: lo[k], k
// = 1 .. C - 1, is the first digit before which k n / C of them lie, so
// bucket k holds digits [lo[k], lo[k + 1]) and about n / C items; pre[k]
// gets the number of items before lo[k].  lo and pre are 0 on entry; the
// caller synchronises before reading them.
__device__ void bucket_bounds(int* lo, int* pre, int acc, const int (&h2)[2], int n, int C) {
  const int d0 = 2 * static_cast<int>(threadIdx.x);
  for (int k = 1; k < C; ++k) {
    const int t = static_cast<int>(static_cast<long long>(k) * n / C);
    if (acc < t && t <= acc + h2[0]) {
      lo[k] = d0 + 1;
      pre[k] = acc + h2[0];
    } else if (acc + h2[0] < t && t <= acc + h2[0] + h2[1]) {
      lo[k] = d0 + 2;
      pre[k] = acc + h2[0] + h2[1];
    }
  }
}

// The bucket of first digit d: the number of bounds lo[1 .. C - 1] at or
// below it.
__device__ __forceinline__ int bucket_of(const int* lo, int C, int d) {
  int q = 0;
  for (int k = 1; k < C; ++k) q += lo[k] <= d;
  return q;
}

// Add v over the block into *dst (shared memory).  Every lane calls it.
__device__ __forceinline__ void block_add(int v, int* dst) {
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, v);
}

// The sum over the cluster's CTAs of rank < upto of *local (an int in
// shared memory).  Every thread calls it after the barrier that completes
// *local everywhere.
__device__ int cluster_reduce(cg::cluster_group& cluster, int* local, int* s_out, int upto) {
  if (threadIdx.x == 0) {
    int t = 0;
    for (int r = 0; r < upto; ++r) t += *cluster.map_shared_rank(local, r);
    *s_out = t;
  }
  __syncthreads();
  const int v = *s_out;
  __syncthreads();
  return v;
}

// A slot in bucket `key`'s array, filled through counter(key), for each lane
// whose `keep` is set: one atomic per bucket per warp.  Every lane calls it.
template <class F>
__device__ __forceinline__ int warp_append_to(bool keep, int key, F counter) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, keep ? key : -1);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (keep && lane == leader) base = atomicAdd(counter(key), __popc(peers));
  base = __shfl_sync(0xFFFFFFFFu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

struct SelectCtl {
  int n_in0, n_in, n_new;  // this CTA's in-range count (first round, insert walk), new states
  int n_cache;             // its in-range entries that the first round kept
  int n_inbox;             // the table entries routed to it
  int n_w, n_l;            // the winners and lattice rows in this CTA's bucket
  int wk;                  // the worst finite kept key of its winners
  int wk_all;              // the same over the cluster, pushed by every CTA
};

// Pass 2, one cluster of C CTAs per channel (grid B * C), everything else:
//  1. the channel's best key and list length from pass 1, and its
//     thresholds; each CTA clears its share of the hash table;
//  2. where the list is longer than min(K2, R) or than kHeavyList (a
//     "heavy" channel), rounds of radix digits over it (each CTA
//     histograms its share, every CTA sums the cluster's histograms through
//     distributed shared memory) find n_in, the in-range count, and the
//     cuts that n_in needs: D, the K2 smallest by (key, e), kept as a set,
//     and L, the R smallest; the first round caches the in-range entries;
//  3. one walk: the members of L go to their bucket's CTA; those of D
//     within the beam whose next state is not S go into an open-addressing
//     hash table keyed by next state, spread over the cluster's shared
//     memory (CTA r holds slots [r per, (r + 1) per)), its value the
//     smallest (key << 32 | e): the entries are the source's winners, one
//     per state, each its state's smallest (cost, e).  Heavy, each goes
//     through its slot owner's inbox;
//  4. the winners in order of (key, state): a cut at K by rounds over the
//     table where needed (heavy: unless every bucket holds its share of all
//     of them, then the ranks past K are dropped); W goes to its bucket's
//     CTA as (key << 32 | state);
//  5. each CTA ranks its buckets and writes their rows at the bucket's
//     offset plus the rank: the lattice rows (pm and cost, provisionally
//     all kept) and the frontier and its records (e by a table lookup,
//     then pm, tsil);
//  6. wk, the worst finite kept cost, from every CTA's winners; each CTA
//     then drops its lattice rows above wk + lattice_beam.
// Buckets: a heavy channel splits W and L in C buckets each, by ranges of
// the first radix digit chosen from its histogram so that each holds about
// 1 / C of them: CTA r ranks bucket r of L (before step 4), then bucket r
// of W.  A light one keeps W in rank 0 and L in rank 1, ranked side by side
// after step 4.  kGlobal = false (buckets of at most kSortCap keys, at most
// kTableCap slots; max-active up to 8,192): table and buckets in shared
// memory.  kGlobal = true: per-channel rows of global scratch, with the
// same code.
template <bool kGlobal>
__global__ void __launch_bounds__(kSelThreads, 1)
select_v4_cluster_kernel(const int32_t* __restrict__ cbits, const int32_t* __restrict__ nsm,
                         const int32_t* __restrict__ pm, long long E,
                         int32_t* __restrict__ chan_best, int32_t* __restrict__ chan_count,
                         const uint32_t* __restrict__ list, const int32_t* __restrict__ tok_state,
                         const float* __restrict__ tok_cost, const int32_t* __restrict__ tok_tsil,
                         const uint8_t* __restrict__ valid, long long valid_stride, float beam,
                         float lattice_beam, int K, int K2, int R, int S, int mbits, int slots,
                         int cache_cap, int32_t* __restrict__ new_state, float* __restrict__ new_cost,
                         int32_t* __restrict__ new_tsil, int32_t* __restrict__ rec_pm,
                         int32_t* __restrict__ rec_state, float* __restrict__ rec_fcost,
                         int32_t* __restrict__ rec_lat_pm, float* __restrict__ rec_lat_cost,
                         uint64_t* glob_s, int32_t* glob_tk, uint64_t* glob_tv,
                         int32_t* stats) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[32];
  __shared__ int s_int[4];
  __shared__ int s_lo[2][kMaxCluster + 1];  // bucket bounds of L and W
  __shared__ int s_pre[kMaxCluster + 1];    // items before W's bounds
  __shared__ SelectCtl ctl;
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const long long bK = static_cast<long long>(b) * K, bR = static_cast<long long>(b) * R;
  const long long bE = static_cast<long long>(b) * E;
  const int per = (slots + C - 1) / C;  // table slots of each CTA
  const uint32_t T = static_cast<uint32_t>(per) * C;
  const int cap = rank_size(max(K, R));  // keys of a bucket
  int* hist = reinterpret_cast<int*>(smem);  // [round parity][target][kBins]
  const SelectSmem lay = select_smem(per, cap, kGlobal);
  auto* tv = reinterpret_cast<uint64_t*>(smem + lay.tv);
  auto* tk = reinterpret_cast<int32_t*>(smem + lay.tk);
  uint64_t* sbuf = kGlobal ? glob_s + (static_cast<long long>(b) * kMaxCluster + r) * cap
                           : reinterpret_cast<uint64_t*>(smem + lay.buf);
  auto* cache = reinterpret_cast<uint64_t*>(smem + lay.cache);
  int32_t* tk_g = kGlobal ? glob_tk + static_cast<long long>(b) * T : nullptr;
  uint64_t* tv_g = kGlobal ? glob_tv + static_cast<long long>(b) * T : nullptr;

  if (valid[static_cast<long long>(b) * valid_stride] == 0) {
    // a masked frame: the old frontier, identity records
    for (int j = r * kSelThreads + tid; j < max(K, R); j += C * kSelThreads) {
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

  // 1. the best key, the list length, the thresholds; empty histograms and
  // table; pass 1's counters reset for the next call once every CTA has
  // read them
  const int32_t best = chan_best[b];
  const int n_super = chan_count[b];
  const Thresholds th = thresholds(best, beam, lattice_beam);
  for (int i = tid; i < 4 * kBins; i += kSelThreads) hist[i] = 0;
  for (int i = tid; i < per; i += kSelThreads) {
    if (kGlobal) {
      tk_g[static_cast<long long>(r) * per + i] = -1;
      tv_g[static_cast<long long>(r) * per + i] = kNone;
    } else {
      tk[i] = -1;
      tv[i] = kNone;
    }
  }
  if (tid < 2 * (kMaxCluster + 1)) s_lo[tid / (kMaxCluster + 1)][tid % (kMaxCluster + 1)] = 0;
  if (tid < kMaxCluster + 1) s_pre[tid] = 0;
  if (tid == 0) ctl = {0, 0, 0, 0, 0, 0, 0, kNoKey, kNoKey};
  cluster.sync();
  if (r == 0 && tid == 0) {
    chan_best[b] = kBig;
    chan_count[b] = 0;
  }
  const uint32_t base = ukey(best);
  const int key_top = 32 - __clz((th.range - base) | 1u);
  const int e_top = 32 - __clz(static_cast<uint32_t>(E - 1) | 1u);
  const int s_top = 32 - __clz(static_cast<uint32_t>(S) | 1u);
  const int K2e = static_cast<int>(min(static_cast<long long>(K2), E));
  const bool heavy = n_super > kHeavyList;
  // the first radix digit of a key: the buckets' ranges are of it
  const int shift0 = key_top - min(kHistBits, key_top);
  auto digit0 = [&](uint32_t u) { return static_cast<int>((u - base) >> shift0); };

  // this CTA's share of the list: fn(in range, u, e) for each entry, called
  // by every lane of every warp the same number of times; from the cache
  // once the first round has filled it (and it held them all)
  const uint32_t* chan_list = list + bE;
  const int stride = C * kSelThreads;
  bool cached = false;
  auto walk_list = [&](auto fn) {
    if (cached) {
      for (int i0 = 0; i0 < ctl.n_cache; i0 += kSelThreads) {
        const bool in = i0 + tid < ctl.n_cache;
        const uint64_t v = in ? cache[i0 + tid] : kNone;
        fn(in, static_cast<uint32_t>(v >> 32), static_cast<uint32_t>(v));
      }
      return;
    }
    for (int g0 = r * kSelThreads; g0 < n_super; g0 += stride * kWalkPer) {
      uint32_t e[kWalkPer], u[kWalkPer];
#pragma unroll
      for (int q = 0; q < kWalkPer; ++q) {
        const int g = g0 + q * stride + tid;
        e[q] = g < n_super ? chan_list[g] : 0u;
      }
#pragma unroll
      for (int q = 0; q < kWalkPer; ++q) {
        const int g = g0 + q * stride + tid;
        u[q] = g < n_super ? ukey(__ldg(cbits + bE + e[q])) : 0xFFFFFFFFu;
      }
#pragma unroll
      for (int q = 0; q < kWalkPer; ++q) fn(u[q] <= th.range, u[q], e[q]);
    }
  };
  // this CTA's table slots: fn(occupied, u, state), as walk_list
  auto walk_slots = [&](auto fn) {
    for (int i0 = 0; i0 < per; i0 += kSelThreads) {
      const int i = i0 + tid;
      int32_t k = -1;
      uint64_t v = kNone;
      if (i < per) {
        if (kGlobal) {
          k = __ldcg(tk_g + static_cast<long long>(r) * per + i);
          v = ld_cg(tv_g + static_cast<long long>(r) * per + i);
        } else {
          k = tk[i];
          v = tv[i];
        }
      }
      fn(k >= 0, static_cast<uint32_t>(v >> 32), static_cast<uint32_t>(k));
    }
  };
  auto key_at = [&](uint32_t s) -> int32_t* {
    return kGlobal ? tk_g + s : cluster.map_shared_rank(tk, s / per) + s % per;
  };
  auto val_at = [&](uint32_t s) -> uint64_t* {
    return kGlobal ? tv_g + s : cluster.map_shared_rank(tv, s / per) + s % per;
  };
  auto slot_of = [&](int32_t state) {  // multiplicative hash, scaled onto [0, T)
    return __umulhi(static_cast<uint32_t>(state) * 0x9E3779B1u, T);
  };
  auto buf_of = [&](int q) -> uint64_t* {
    return kGlobal ? glob_s + (static_cast<long long>(b) * kMaxCluster + q) * cap
                   : cluster.map_shared_rank(sbuf, q);
  };
  // histograms of this round: parity round & 1, target t
  int round = 0;
  auto hist_of = [&](int t) { return hist + ((round & 1) * 2 + t) * kBins; };
  auto next_round = [&]() {  // clear the other parity, last read a round ago
    int* h = hist + ((round + 1) & 1) * 2 * kBins;
    for (int i = tid; i < 2 * kBins; i += kSelThreads) h[i] = 0;
    __syncthreads();
    ++round;
  };

  // 2. the cuts D (K2e smallest) and L (R smallest), where the list may
  // hold more in-range candidates than either, or is long enough for
  // buckets; the first round counts n_in and gives L's bucket bounds
  Cut cd = cut_all(), cl = cut_all();
  if (heavy || n_super > min(K2e, R)) {
    cd = cut_at(K2e, key_top);
    cl = cut_at(R, key_top);
    bool first = true;
    while (cd.field != 2 || cl.field != 2) {
      const bool share = cd.field == cl.field && cd.top == cl.top && cd.prefix == cl.prefix &&
                         cd.key == cl.key;
      int* hd = hist_of(0);
      int* hl = share ? hd : hist_of(1);
      int n = 0;
      walk_list([&](bool in, uint32_t u, uint32_t e) {
        n += in;
        hist_add(hd, in && cd.field != 2 ? cut_bin(cd, u, e, base) : -1);
        if (!share) hist_add(hl, in && cl.field != 2 ? cut_bin(cl, u, e, base) : -1);
        if (first) {
          const int p = warp_append(in, &ctl.n_cache);
          if (in && p < cache_cap) cache[p] = (static_cast<uint64_t>(u) << 32) | e;
        }
      });
      if (first) block_add(n, &ctl.n_in0);
      cluster.sync();
      cached = ctl.n_cache <= cache_cap;
      int h2[2] = {0, 0};
      int acc = cd.field != 2 ? hist_sum(cluster, hd, cut_bins(cd), h2, s_warp) : 0;
      if (first) {  // both cuts share the first round
        const int n_in = cluster_reduce(cluster, &ctl.n_in0, &s_int[3], C);
        if (heavy) bucket_bounds(s_lo[0], s_pre, acc, h2, min(n_in, R), C);
        if (n_in <= K2e) cd = cut_all();
        if (n_in <= R) cl = cut_all();
        first = false;
      }
      if (cd.field != 2) cut_advance(cd, acc, h2, base, e_top, s_int);
      if (cl.field != 2) {
        if (!share) acc = hist_sum(cluster, hl, cut_bins(cl), h2, s_warp);
        cut_advance(cl, acc, h2, base, e_top, s_int);
      }
      next_round();
    }
  }

  // 3. L into its buckets; D's in-beam candidates into the table.  Heavy,
  // in shared memory: each goes to the inbox of the CTA that holds its
  // state's home slot (the histograms' memory, idle until step 4), which
  // then inserts its inbox with its own atomics; an inbox's overflow, and
  // the other cases, insert from the walk
  auto insert = [&](int32_t ns, uint64_t v) -> int {  // 1 if ns is new
    uint32_t s = slot_of(ns);
    for (;;) {
      const bool mine = !kGlobal && s / per == static_cast<uint32_t>(r);
      const int32_t old = atomicCAS(mine ? tk + (s - r * per) : key_at(s), -1, ns);
      if (old == -1 || old == ns) {
        if (mine)  // a 64-bit atomic minimum is sound in the CTA's own memory
          atomicMin(reinterpret_cast<unsigned long long*>(tv + (s - r * per)), v);
        else
          atomic_min64(val_at(s), v);
        return old == -1;
      }
      s = s + 1 == T ? 0 : s + 1;
    }
  };
  const bool routed = heavy && !kGlobal;
  auto* inbox = reinterpret_cast<uint64_t*>(hist);
  if (routed) cluster.sync();  // every CTA is done with the histograms
  {
    int n = 0, fresh = 0;
    walk_list([&](bool in, uint32_t u, uint32_t e) {
      n += in;
      const bool to_l = in && cut_keeps(cl, u, e);
      const int q = heavy ? bucket_of(s_lo[0], C, to_l ? digit0(u) : 0) : 1;
      const int p = warp_append_to(to_l, q, [&](int k) {
        return cluster.map_shared_rank(&ctl.n_l, k);
      });
      const uint64_t v = (static_cast<uint64_t>(u) << 32) | e;
      if (to_l) buf_of(q)[p] = v;
      const bool to_d =
          in && cut_keeps(cd, u, e) && static_cast<int32_t>(u ^ 0x80000000u) <= th.keep;
      const int32_t ns = to_d ? __ldg(nsm + bE + e) : S;
      if (routed) {
        const int own = ns != S ? static_cast<int>(slot_of(ns) / per) : 0;
        const int at = warp_append_to(ns != S, own, [&](int k) {
          return cluster.map_shared_rank(&ctl.n_inbox, k);
        });
        if (ns != S) {
          if (at < kInbox) cluster.map_shared_rank(inbox, own)[at] = v;
          else fresh += insert(ns, v);
        }
      } else if (ns != S) {
        fresh += insert(ns, v);
      }
    });
    block_add(n, &ctl.n_in);
    block_add(fresh, &ctl.n_new);
  }
  cluster.sync();
  if (routed) {
    int fresh = 0;
    const int n = min(ctl.n_inbox, kInbox);
    for (int i0 = 0; i0 < n; i0 += kSelThreads) {
      if (i0 + tid < n) {
        const uint64_t v = inbox[i0 + tid];
        fresh += insert(__ldg(nsm + bE + static_cast<uint32_t>(v)), v);
      }
    }
    block_add(fresh, &ctl.n_new);  // every lane: the loop above has no barrier
    __syncthreads();                // the inbox read, its memory is histograms again
    for (int i = tid; i < 4 * kBins; i += kSelThreads) hist[i] = 0;
    cluster.sync();
  }
  const int n_win = cluster_reduce(cluster, &ctl.n_new, &s_int[3], C);
  const int n_lat = cluster_reduce(cluster, &ctl.n_l, &s_int[3], C);
  const int lat_off = cluster_reduce(cluster, &ctl.n_l, &s_int[3], r);
  if (stats) {
    const int n_in = cluster_reduce(cluster, &ctl.n_in, &s_int[3], C);
    if (r == 0 && tid == 0) {
      stats[3 * b] = n_super;
      stats[3 * b + 1] = n_in;
      stats[3 * b + 2] = n_win;
    }
  }

  // fn(rank, key) for the n keys of this CTA's bucket a: where they fit in
  // the cache's memory (idle by now) and no first digit holds more than
  // kGroup of them, a counting sort by first digit and a count within each
  // digit's group (under load a few keys); else rank_keys.  The digits are
  // counted in the histograms' memory (idle too), left zero.
  auto rank_bucket = [&](uint64_t* a, int n, auto fn) {
    int* cnt = hist;              // keys of each first digit
    int* start = hist + kBins;    // where its group starts
    int* fill = hist + 2 * kBins;
    auto digit = [&](uint64_t x) { return digit0(static_cast<uint32_t>(x >> 32)); };
    auto clear = [&]() {
      for (int i = tid; i < 4 * kBins; i += kSelThreads) hist[i] = 0;
      __syncthreads();
    };
    if (rank_size(n) <= cache_cap) {
      clear();
      for (int i = tid; i < n; i += kSelThreads) atomicAdd(&cnt[digit(a[i])], 1);
      __syncthreads();
      const int d0 = 2 * tid, c0 = cnt[d0], c1 = cnt[d0 + 1];
      int tot;
      const int acc = block_excl_scan<kSelThreads>(c0 + c1, s_warp, &tot);
      start[d0] = acc;
      start[d0 + 1] = acc + c0;
      if (-block_min<kSelThreads>(-max(c0, c1), s_warp) <= kGroup) {
        for (int i = tid; i < n; i += kSelThreads) {
          const uint64_t x = a[i];
          const int d = digit(x);
          cache[start[d] + atomicAdd(&fill[d], 1)] = x;
        }
        __syncthreads();
        for (int i = tid; i < n; i += kSelThreads) {
          const uint64_t x = cache[i];
          const int d = digit(x), g0 = start[d], g1 = g0 + cnt[d];
          int below = 0;
          for (int j = g0; j < g1; ++j) below += cache[j] < x;
          fn(g0 + below, x);
        }
        __syncthreads();
        clear();
        return;
      }
      // large groups: rank a copy in the cache's memory (a may be global)
      for (int i = tid; i < n; i += kSelThreads) cache[i] = a[i];
      clear();
      rank_keys(cache, n, fn);
      return;
    }
    clear();
    rank_keys(a, n, fn);
  };

  // 5a. this CTA's bucket of L in order, its rows written as if all kept
  auto lattice_rows = [&]() {
    rank_bucket(sbuf, ctl.n_l, [&](int i, uint64_t c) {
      rec_lat_pm[bR + lat_off + i] = pm[bE + static_cast<uint32_t>(c)] & kPmMask;
      rec_lat_cost[bR + lat_off + i] = key_cost(key_of(c));
    });
  };
  if (heavy) lattice_rows();  // its buffer then takes the winners

  // 4. the K first winners by (key, state) into their buckets; heavy, where
  // every bucket can hold its share of all n_win winners, all of them, and
  // the ranks past K are dropped instead of cut
  Cut cw = cut_all();
  bool all_w = false;
  if (heavy || n_win > K) {
    cw = cut_at(K, key_top);
    bool first = true;
    while (cw.field != 2) {
      int* h = hist_of(0);
      walk_slots([&](bool occ, uint32_t u, uint32_t st) {
        hist_add(h, occ ? cut_bin(cw, u, st, base) : -1);
      });
      cluster.sync();
      int h2[2];
      const int acc = hist_sum(cluster, h, cut_bins(cw), h2, s_warp);
      if (first && heavy) {
        if (tid <= kMaxCluster) s_pre[tid] = 0;  // L's bounds wrote it
        __syncthreads();
        bucket_bounds(s_lo[1], s_pre, acc, h2, n_win, C);
        __syncthreads();
        int most = n_win - s_pre[C - 1];
        for (int k = 1; k < C; ++k) most = max(most, s_pre[k] - s_pre[k - 1]);
        all_w = most <= cap;
        __syncthreads();
        if (!all_w) {  // the cut first; buckets of its K
          if (tid <= kMaxCluster) s_lo[1][tid] = s_pre[tid] = 0;
          __syncthreads();
          bucket_bounds(s_lo[1], s_pre, acc, h2, min(n_win, K), C);
        }
      }
      if (first) {
        if (n_win <= K || all_w) cw = cut_all();
        first = false;
      }
      if (cw.field != 2) cut_advance(cw, acc, h2, base, s_top, s_int);
      next_round();
    }
  }
  walk_slots([&](bool occ, uint32_t u, uint32_t st) {
    const bool take = occ && cut_keeps(cw, u, st);
    const int q = heavy ? bucket_of(s_lo[1], C, take ? digit0(u) : 0) : 0;
    const int p = warp_append_to(take, q, [&](int k) {
      return cluster.map_shared_rank(&ctl.n_w, k);
    });
    if (take) buf_of(q)[p] = (static_cast<uint64_t>(u) << 32) | st;
  });
  cluster.sync();

  // 5b. this CTA's bucket of W in order: the frontier and its records
  if (!heavy && r == 1) lattice_rows();
  const int n_kept = min(cluster_reduce(cluster, &ctl.n_w, &s_int[3], C), K);
  const int w_off = cluster_reduce(cluster, &ctl.n_w, &s_int[3], r);
  if (heavy || r == 0) {
    rank_bucket(sbuf, ctl.n_w, [&](int i, uint64_t c) {
      if (w_off + i >= K) return;  // past the frontier (all_w)
      const int32_t st = static_cast<int32_t>(static_cast<uint32_t>(c));
      const int32_t key = key_of(c);
      uint32_t s = slot_of(st);
      while ((kGlobal ? __ldcg(key_at(s)) : *key_at(s)) != st) s = s + 1 == T ? 0 : s + 1;
      const uint32_t e = static_cast<uint32_t>(kGlobal ? ld_cg(val_at(s)) : *val_at(s));
      const int32_t p = pm[bE + e];
      const int prev = static_cast<int>(static_cast<uint32_t>(p & kPmMask) >> mbits);
      const int32_t pts = prev < K ? __ldg(tok_tsil + bK + prev) : 0;
      const int32_t ft = (p & kPmSil) ? (((pts & kTsilMask) + 1) | (pts & kSpeech)) : kSpeech;
      const float fc = key_cost(key);
      const long long j = bK + w_off + i;
      new_state[j] = st;
      new_cost[j] = fc;
      new_tsil[j] = ft;
      rec_pm[j] = p & kPmMask;
      rec_state[j] = st;
      rec_fcost[j] = fc;
      if (key > -kPosInfKey && key < kPosInfKey) atomicMax(&ctl.wk, key);
    });
  }
  // the rows past the kept winners and past L, over the whole cluster
  for (int j = n_kept + r * kSelThreads + tid; j < K; j += C * kSelThreads) {
    new_state[bK + j] = S;
    new_cost[bK + j] = INFINITY;
    new_tsil[bK + j] = 0;
    rec_pm[bK + j] = -1;
    rec_state[bK + j] = S;
    rec_fcost[bK + j] = INFINITY;
  }
  for (int j = n_lat + r * kSelThreads + tid; j < R; j += C * kSelThreads) {
    rec_lat_pm[bR + j] = -1;
    rec_lat_cost[bR + j] = INFINITY;
  }
  __syncthreads();
  if (tid < C && ctl.wk != kNoKey) atomicMax(cluster.map_shared_rank(&ctl.wk_all, tid), ctl.wk);
  cluster.sync();

  // 6. wk over the cluster; this CTA's lattice rows above wk + lattice_beam
  // dropped (no CTA touches another's shared memory after the barrier)
  const int wk_key = ctl.wk_all;
  const float wk = wk_key == kNoKey ? -INFINITY : key_cost(wk_key);
  const float lat_lim = __fadd_rn(wk, lattice_beam);
  for (int i = tid; i < ctl.n_l; i += kSelThreads) {
    if (!(rec_lat_cost[bR + lat_off + i] <= lat_lim)) {  // every member of L is below BIG
      rec_lat_pm[bR + lat_off + i] = -1;
      rec_lat_cost[bR + lat_off + i] = INFINITY;
    }
  }
}

// Let kernel fn take as much dynamic shared memory as the current device
// allows a block beside its static part, once per device; *limit gets that
// amount (cached in `limits`, the kernel's own, as the amount + 1).
template <class F>
cudaError_t allow_max_smem(F* fn, std::atomic<int>* limits, int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && (*limit = limits[dev].load(std::memory_order_acquire) - 1) >= 0)
    return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attr{};
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *limit = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (err == cudaSuccess && known) limits[dev].store(*limit + 1, std::memory_order_release);
  return err;
}

// CTAs per channel: the most, up to kMaxCluster, with which the device holds
// all B clusters at once, and at least 2.  H100 holds 66 clusters of 2 of
// these CTAs (one an SM), 39 of 3, 30 of 4 and 15 of 8, so B = 32 takes 3
// and B = 1 takes 8.  cudaOccupancyMaxActiveClusters is asked once per
// device and size, at the most shared memory a CTA of that size takes
// (`fit` caches the answer + 1).
template <class F>
int cluster_size(F* fn, int B, bool global, std::atomic<int> (*fit)[kMaxCluster + 1]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 2;
  for (int C = kMaxCluster; C > 2; --C) {
    int n = fit[dev][C].load(std::memory_order_acquire) - 1;
    if (n < 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(
          dim3(C), kSelThreads, C,
          select_smem((kTableCap + C - 1) / C, kSortCap, global).cache + 8 * kSelThreads,
          nullptr, &attr);
      if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
        cudaGetLastError();
        n = 0;
      }
      fit[dev][C].store(n + 1, std::memory_order_release);
    }
    if (B <= n) return C;
  }
  return 2;
}

// Launch the expand kernel over grid (tiles, B).
template <int kPlanes, bool kVec4, bool kStaged>
cudaError_t launch_expand(dim3 grid, cudaStream_t s, const int32_t* em_pack,
                          const int32_t* tok_state, const float* tok_cost, const float* ll,
                          long long ll_stride, int n_ll, int pdf_bits, float neg_scale, int K,
                          Stripe stripe, int S, int M, int mbits, int32_t* cbits, int32_t* nsm,
                          int32_t* pm) {
  const size_t smem = kStaged ? static_cast<size_t>(n_ll) * 4 : 0;
  if (smem > kStaticSmemLimit - kStageReserve) {
    static std::atomic<bool> smem_allowed[kMaxDevices];
    const cudaError_t err = allow_smem(expand_v4_kernel<kPlanes, kVec4, kStaged>,
                                       stage_smem_limit(), smem_allowed);
    if (err != cudaSuccess) return err;
  }
  expand_v4_kernel<kPlanes, kVec4, kStaged><<<grid, kThreads, smem, s>>>(
      em_pack, tok_state, tok_cost, ll, ll_stride, n_ll, pdf_bits, neg_scale, K, stripe, S, M,
      mbits, cbits, nsm, pm);
  return cudaGetLastError();
}

}  // namespace

// planes: 2 for packed16 rows, 3 for exact3 rows (pdf_bits the width of
// their pdf field, 1..31; unused for packed16).  K tokens a channel: slots
// slot_base + k * slot_stride of a frontier whose rows hold tok_row slots
// (the whole frontier: K, 0, 1).  stage_req: -1 picks as below, 0 asks for
// the staged row, 1 for reads in place (a row the bulk copy cannot take,
// or too long for shared memory, is always read in place).  cbits gets
// every candidate's key; nsm and pm are defined where cbits < BIG.
extern "C" int vt_expand_v4(const void* em_pack, const void* tok_state, const void* tok_cost,
                            const void* ll, long long ll_stride, int P, float scale, int B,
                            int K, long long tok_row, int slot_base, int slot_stride, int S,
                            int M, int mbits, int planes, int pdf_bits, void* cbits, void* nsm,
                            void* pm, int stage_req, void* stream) {
  if ((planes != 2 && planes != 3) || (planes == 3 && (pdf_bits < 1 || pdf_bits > 31)) ||
      slot_base < 0 || slot_stride < 1 || stage_req < -1 || stage_req > 1 ||
      (K > 0 && slot_base + static_cast<long long>(K - 1) * slot_stride >= tok_row))
    return static_cast<int>(cudaErrorInvalidValue);
  const Stripe stripe{tok_row, slot_base, slot_stride};
  // the ll words a lookup can reach: pdf ids of packed16 rows are below 2^14
  const int n_ll = planes == 2 && P > kPdfWords ? kPdfWords : P;
  const bool vec4 = M == 4;
  const long long per_block = vec4 ? kThreads : static_cast<long long>(kThreads) * kCandPer;
  const long long units = vec4 ? K : static_cast<long long>(K) * M;
  const dim3 grid(static_cast<unsigned>((units + per_block - 1) / per_block), B);
  // The kernel's own choice, from the card's interleaved times (PERF.md):
  // the staged row pays only while every block has an SM, and its L1, to
  // itself and a channel spans at least 8 blocks (a B = 1 stream over the
  // whole frontier); one block (a grammar frame) or few (the K = 1024 rung)
  // do better reading in place, and so does every grid with more blocks
  // than SMs, whose blocks of a channel share an SM's L1.  A row above
  // 2^14 words costs each block more to copy than its lookups save.  The
  // bulk copy needs a 16-byte aligned source and a multiple of 16 bytes.
  const bool fits = reinterpret_cast<uintptr_t>(ll) % 16 == 0 && ll_stride % 4 == 0 &&
                    n_ll % 4 == 0 && static_cast<long long>(n_ll) * 4 <= stage_smem_limit();
  const bool staged = fits && (stage_req < 0 ? static_cast<long long>(grid.x) * B <= num_sms() &&
                                                   grid.x >= 8 && n_ll <= kPdfWords
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
#define VT_EXPAND(PLANES, VEC4, STAGED)                                                      \
  launch_expand<PLANES, VEC4, STAGED>(grid, s, e, ts, tc, l, ll_stride, n_ll, pdf_bits, neg, K, \
                                      stripe, S, M, mbits, c, n, p)
#define VT_EXPAND_ROWS(PLANES)                                                              \
  (vec4 ? (staged ? VT_EXPAND(PLANES, true, true) : VT_EXPAND(PLANES, true, false))        \
        : (staged ? VT_EXPAND(PLANES, false, true) : VT_EXPAND(PLANES, false, false)))
  const cudaError_t err = planes == 2 ? VT_EXPAND_ROWS(2) : VT_EXPAND_ROWS(3);
#undef VT_EXPAND_ROWS
#undef VT_EXPAND
  return static_cast<int>(err);
}

// list: [B * E] uint32 (pass 1's candidate numbers); chan_best / chan_count
// [B], BIG and 0 on the first call (pass 2 leaves them so).  Where a sort
// takes more than kSortCap keys (K or R) or the table more than kTableCap
// slots (slots = max(kMinSlots, ceil(5 min(K2, E) / 4))), pass 2 works in
// global scratch: glob_s [B * kMaxCluster * rank_size(max(K, R))] (uint64,
// the buckets), glob_tk [B * (slots + kMaxCluster)]
// (int32) and glob_tv [the same] (uint64, the table); else they may be
// null.  stats: null, or [B * 3] int32 that gets each valid channel's list
// length, in-range count and winner count.
extern "C" int vt_select_v4(
    const void* cbits, const void* nsm, const void* pm, long long E, const void* tok_state,
    const void* tok_cost, const void* tok_tsil, const void* valid, long long valid_stride,
    float beam, float lattice_beam, int B, int K, int K2, int R, int S, int mbits,
    void* chan_best, void* chan_count, void* list, void* new_state, void* new_cost,
    void* new_tsil, void* rec_pm, void* rec_state, void* rec_fcost, void* rec_lat_pm,
    void* rec_lat_cost, void* glob_s, void* glob_tk, void* glob_tv, void* stats,
    void* stream) {
  const long long n_tiles = (E + kTile - 1) / kTile;
  if (B <= 0 || K <= 0 || n_tiles <= 0 || n_tiles > 0x7FFFFFFF || K2 <= 0 || R <= 0 ||
      static_cast<long long>(B) * kMaxCluster > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cb = static_cast<const int32_t*>(cbits);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* best = static_cast<int32_t*>(chan_best);
  auto* count = static_cast<int32_t*>(chan_count);
  auto* l = static_cast<uint32_t*>(list);
  select_v4_scan_kernel<<<dim3(static_cast<unsigned>(n_tiles), B), kScanThreads, 0, s>>>(
      cb, E, v, valid_stride, beam, lattice_beam, best, count, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long K2e = K2 < E ? K2 : E;
  const int slots = static_cast<int>(kMinSlots > (5 * K2e + 3) / 4 ? kMinSlots
                                                                    : (5 * K2e + 3) / 4);
  const int cap = rank_size(K > R ? K : R);
  const bool global = cap > kSortCap || slots > kTableCap;
  if (global && (glob_s == nullptr || glob_tk == nullptr || glob_tv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = [&](auto* kern, std::atomic<int>* smem_limit,
                    std::atomic<int> (*fit)[kMaxCluster + 1]) {
    int limit = 0;
    cudaError_t e = allow_max_smem(kern, smem_limit, &limit);
    if (e != cudaSuccess) return e;
    // no more CTAs than the pool has tiles of pass 1 (a small pool pays
    // for every CTA at each cluster barrier), and at least 2
    const int C = static_cast<int>(std::max(2LL, std::min(static_cast<long long>(
                                               cluster_size(kern, B, global, fit)), n_tiles)));
    const size_t used = select_smem((slots + C - 1) / C, cap, global).cache;
    if (used + 8 * kSelThreads > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
    const int cache_cap = static_cast<int>((limit - used) / 8);
    const size_t smem = used + static_cast<size_t>(cache_cap) * 8;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(static_cast<unsigned>(B * C)), kSelThreads, C, smem, s, &attr);
    return cudaLaunchKernelEx(
        &cfg, kern, cb, static_cast<const int32_t*>(nsm), static_cast<const int32_t*>(pm), E,
        best, count, static_cast<const uint32_t*>(l), static_cast<const int32_t*>(tok_state),
        static_cast<const float*>(tok_cost), static_cast<const int32_t*>(tok_tsil), v,
        valid_stride, beam, lattice_beam, K, K2, R, S, mbits, slots, cache_cap,
        static_cast<int32_t*>(new_state), static_cast<float*>(new_cost),
        static_cast<int32_t*>(new_tsil), static_cast<int32_t*>(rec_pm),
        static_cast<int32_t*>(rec_state), static_cast<float*>(rec_fcost),
        static_cast<int32_t*>(rec_lat_pm), static_cast<float*>(rec_lat_cost),
        static_cast<uint64_t*>(glob_s), static_cast<int32_t*>(glob_tk),
        static_cast<uint64_t*>(glob_tv), static_cast<int32_t*>(stats));
  };
  static std::atomic<int> smem_limit[2][kMaxDevices];
  static std::atomic<int> fit[2][kMaxDevices][kMaxCluster + 1];
  err = global ? launch(select_v4_cluster_kernel<true>, smem_limit[1], fit[1])
               : launch(select_v4_cluster_kernel<false>, smem_limit[0], fit[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
