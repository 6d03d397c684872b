// The v4 frame step's two kernels for Hopper: expand, and the tail of select.
//
// Together they replace vosk_tpu/ops/gather.py:_pallas_gather, the TPU
// kernel that the JAX decoder calls twice per frame, and the element-wise
// ops around each call:
//   expand_v4_kernel       vosk_tpu/ops/viterbi.py _unpack_rows_v4 +
//                          _expand_v4 (:833-894), with the acoustic lookup
//                          ll[b, pdf] (:879);
//   select_tail_v4_kernel  _select_v4 after its sorts (:1094-1154), with the
//                          trailing-silence lookup tsil[b, prev] (:1105).
// The sorts between them stay torch ops (the source's lax.sort calls).
// Plain versions and wrappers: vosk_tpu_torch/ops/frame_step.py.
//
// What bounds them: bytes.  Neither does more than a few integer and one
// fused multiply-add per element; expand moves about 20.5 MB per frame at
// B = 32, K = 7000, M = 4 with every token live (arc rows 7.2 MB, three
// [B, K*M] outputs 10.8 MB), the tail about 15 MB when every slot survives.
// Real frames keep far fewer tokens, and both kernels read only what those
// need: no arc row or cost of a dead token, no winner payload or silence
// count past the kept prefix, no lattice pm past the kept lattice prefix.
// There the chains of dependent loads set the tail's time more than its
// bytes do, and at B = 1 launch and ramp time set both.
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
//  * the tail: each block finds the worst surviving winner itself, by a
//    32-way search of an extra warp over its channel's sorted keys (the
//    kept winners are a prefix; 3 steps at K = 7000) while its slot
//    threads write the frontier, so no reduction crosses blocks; the old
//    tsil row is read through the read-only path (28 KB, in L2).
//
// Bit parity with the JAX decoder on the CPU: the cost is
// fma(-scale, ac, tok_cost + w) with both roundings explicit (XLA contracts
// the source's expression the same way; no plain * or + that nvcc could
// contract); the f16 weight is converted with __half2float; cost keys use
// unsigned arithmetic (signed overflow is undefined in C++).
//
// Plain C interface (loaded with ctypes): each function launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTailThreads = kThreads + 32;  // the tail's slot threads + a search warp
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

// One thread per slot j of max(K, R), plus one warp that searches.  The
// time of a block is its chain of dependent loads, not its bytes: the
// kept winners walk o2 -> (sb_n, sb_p) -> tsil, and the worst surviving
// winner takes a 32-way search; so the search runs in a warp of its own,
// beside the slot threads, and each slot's lattice key is loaded before
// the barrier that waits for the search.
__global__ void __launch_bounds__(kTailThreads)
select_tail_v4_kernel(const int32_t* __restrict__ sc_k, const int64_t* __restrict__ o2,
                      const int32_t* __restrict__ sb_n, const int32_t* __restrict__ sb_p,
                      int K2, const int32_t* __restrict__ lat_cb, long long lat_cb_stride,
                      const int32_t* __restrict__ lat_pm, long long lat_pm_stride,
                      const int32_t* __restrict__ tok_state, const float* __restrict__ tok_cost,
                      const int32_t* __restrict__ tok_tsil, const uint8_t* __restrict__ valid,
                      long long valid_stride, float beam, float lattice_beam, int K, int R,
                      int S, int mbits, int32_t* __restrict__ new_state,
                      float* __restrict__ new_cost, int32_t* __restrict__ new_tsil,
                      int32_t* __restrict__ rec_pm, int32_t* __restrict__ rec_state,
                      float* __restrict__ rec_fcost, int32_t* __restrict__ rec_lat_pm,
                      float* __restrict__ rec_lat_cost) {
  __shared__ float s_wk;
  const int b = blockIdx.y;
  const long long row2 = static_cast<long long>(b) * K2;
  const bool vb = valid[static_cast<long long>(b) * valid_stride] != 0;
  // beam threshold from the best winner
  const int32_t thr = cost_key(__fadd_rn(key_cost(K2 > 0 ? sc_k[row2] : kBig), beam));
  const bool searcher = threadIdx.x >= kThreads;
  const int j = blockIdx.x * kThreads + threadIdx.x;  // a slot, unless searcher
  const int32_t ident = kPmIdent | (j << mbits);
  int32_t c = kBig;  // this slot's lattice key
  if (searcher) {
    if (vb) {
      // the worst surviving winner: keys ascend and the prune is monotone,
      // so the kept winners are a prefix; wk is the last kept key below
      // +inf, or -inf if that key is -inf (or below) or there is none --
      // the source's max over the finite kept costs.  A 32-way search:
      // count the keys <= lim.
      const int lane = threadIdx.x - kThreads;
      const int32_t lim = min(thr, kPosInfKey - 1);
      int lo = 0, hi = min(K, K2);
      while (lo < hi) {
        const int len = hi - lo;
        const int pos = lo + static_cast<int>(static_cast<long long>(len) * lane / 32);
        const unsigned le = __ballot_sync(0xFFFFFFFFu, sc_k[row2 + pos] <= lim);
        const int n = __popc(le);  // lanes [0, n) hold keys <= lim
        const int first_gt =
            n < 32 ? lo + static_cast<int>(static_cast<long long>(len) * n / 32) : hi;
        lo = n > 0 ? lo + static_cast<int>(static_cast<long long>(len) * (n - 1) / 32) + 1 : lo;
        hi = n > 0 ? first_gt : lo;
      }
      if (lane == 0) {
        float wk = -INFINITY;
        if (lo > 0) {
          const int32_t key = sc_k[row2 + lo - 1];
          if (key > -kPosInfKey) wk = key_cost(key);
        }
        s_wk = wk;
      }
    }
  } else {
    if (vb && j < R) c = lat_cb[static_cast<long long>(b) * lat_cb_stride + j];
    if (j < K) {
      const long long t = static_cast<long long>(b) * K + j;
      int32_t fs, ft, rp;
      float fc;
      if (vb) {
        // the kept slots are a prefix, and only they read their payload
        // (next state, pm word) and the old silence count
        const int32_t kb = j < K2 ? sc_k[row2 + j] : kBig;
        fs = S;
        fc = INFINITY;
        ft = 0;
        rp = -1;
        if (kb < kBig && kb <= thr) {
          const long long o = row2 + o2[row2 + j];
          const int32_t p = sb_p[o];
          const int prev = static_cast<int>(static_cast<uint32_t>(p & kPmMask) >> mbits);
          const int32_t pts =
              prev < K ? __ldg(tok_tsil + static_cast<long long>(b) * K + prev) : 0;
          fs = sb_n[o];
          fc = key_cost(kb);
          ft = (p & kPmSil) ? (((pts & kTsilMask) + 1) | (pts & kSpeech)) : kSpeech;
          rp = p & kPmMask;
        }
      } else {
        fs = tok_state[t];
        fc = tok_cost[t];
        ft = tok_tsil[t];
        rp = ident;
      }
      new_state[t] = fs;
      new_cost[t] = fc;
      new_tsil[t] = ft;
      rec_pm[t] = rp;
      rec_state[t] = fs;
      rec_fcost[t] = fc;
    }
  }
  __syncthreads();  // s_wk
  if (searcher || j >= R) return;
  int32_t lp;
  float lc;
  if (vb) {
    // the lattice rows are cost-ordered too: the kept ones are a prefix
    lc = key_cost(c);
    lp = -1;
    if (c < kBig && lc <= __fadd_rn(s_wk, lattice_beam))
      lp = lat_pm[static_cast<long long>(b) * lat_pm_stride + j] & kPmMask;
    else
      lc = INFINITY;
  } else {
    lp = j < K ? ident : -1;
    lc = j < K ? tok_cost[static_cast<long long>(b) * K + j] : INFINITY;
  }
  const long long t = static_cast<long long>(b) * R + j;
  rec_lat_pm[t] = lp;
  rec_lat_cost[t] = lc;
}

template <bool kVec4, bool kStaged>
cudaError_t launch_expand(dim3 grid, cudaStream_t s, const int32_t* em_pack,
                          const int32_t* tok_state, const float* tok_cost, const float* ll,
                          long long ll_stride, int n_stage, float neg_scale, int K, int S,
                          int M, int mbits, int32_t* cbits, int32_t* nsm, int32_t* pm) {
  const size_t smem = kStaged ? static_cast<size_t>(n_stage) * 4 : 0;
  if (smem > kStaticSmemLimit) {  // per launch: the attribute is per device
    const cudaError_t err = cudaFuncSetAttribute(expand_v4_kernel<kVec4, kStaged>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kPdfWords * 4);
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

extern "C" int vt_select_tail_v4(
    const void* sc_k, const void* o2, const void* sb_n, const void* sb_p, int K2,
    const void* lat_cb, long long lat_cb_stride, const void* lat_pm, long long lat_pm_stride,
    const void* tok_state, const void* tok_cost, const void* tok_tsil, const void* valid,
    long long valid_stride, float beam, float lattice_beam, int B, int K, int R, int S,
    int mbits, void* new_state, void* new_cost, void* new_tsil, void* rec_pm,
    void* rec_state, void* rec_fcost, void* rec_lat_pm, void* rec_lat_cost, void* stream) {
  const int n = K > R ? K : R;
  const dim3 grid((n + kThreads - 1) / kThreads, B);
  select_tail_v4_kernel<<<grid, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sc_k), static_cast<const int64_t*>(o2),
      static_cast<const int32_t*>(sb_n), static_cast<const int32_t*>(sb_p), K2,
      static_cast<const int32_t*>(lat_cb), lat_cb_stride, static_cast<const int32_t*>(lat_pm),
      lat_pm_stride, static_cast<const int32_t*>(tok_state),
      static_cast<const float*>(tok_cost), static_cast<const int32_t*>(tok_tsil),
      static_cast<const uint8_t*>(valid), valid_stride, beam, lattice_beam, K, R, S, mbits,
      static_cast<int32_t*>(new_state), static_cast<float*>(new_cost),
      static_cast<int32_t*>(new_tsil), static_cast<int32_t*>(rec_pm),
      static_cast<int32_t*>(rec_state), static_cast<float*>(rec_fcost),
      static_cast<int32_t*>(rec_lat_pm), static_cast<float*>(rec_lat_cost));
  return static_cast<int>(cudaGetLastError());
}
