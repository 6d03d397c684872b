"""vosk_tpu_torch on the card: the gather kernel, the two frame-step
kernels (expand_v4 over packed16 and exact3 rows and over frontier stripes,
select_v4, also on the sharded search's merged pool), the decoder with
them, its captured chunk programs (CUDA graphs) against its eager body, its
sharded search over ranks that share the card, the AM's captured chunk
programs (a TDNN-F, and an nnet3 AM with i-vectors) against the AM's eager
body, the v3 decoder with
the gather kernel at its four sites, the CSR decoder, a streaming KaldiRecognizer decode
(v4, and v3 on a graph that keeps labeled eps arcs), a Kaldi-layout
directory with i-vectors, the rescoring RNNLMs (Kaldi TDNN-LSTM and
GRU), pitch, x-vectors and one LF-MMI training step against the CPU.

These tests need an NVIDIA GPU and skip without one.  They import neither
jax nor vosk_tpu, so they run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up jax.)
"""
import sys
import threading

import numpy as np
import pytest
import torch

from vosk_tpu_torch.ops import frame_step, viterbi, viterbi_v3
from vosk_tpu_torch.ops.frame_step import (
    expand_v4, expand_v4_plain, select_v4, select_v4_plain,
)
from vosk_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams
from vosk_tpu_torch.utils.benchdata import make_realistic_graph

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card (module docstring)")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_pool(got, ref, what=""):
    """The expand kernel's pool against the plain version's under its
    contract: every key bit-equal, and nsm and pm where the key is below BIG
    (the kernel leaves them unwritten elsewhere)."""
    real = ref[0] < frame_step.BIG_I32
    assert torch.equal(got[0], ref[0]), ("cbits", what)
    for name, a, b in zip(("nsm", "pm"), got[1:], ref[1:]):
        assert torch.equal(a[real], b[real]), (name, what)
    return int((~real).sum())


def _overwrite_payload(pool, seed):
    """The pool with the nsm and pm of every BIG-keyed candidate replaced by
    seeded garbage; returns (pool, words overwritten a plane)."""
    cb, nsm, pm = (x.clone() for x in pool)
    big = cb == frame_step.BIG_I32
    n = int(big.sum())
    g = torch.Generator().manual_seed(seed)
    for plane in (nsm, pm):
        plane[big] = torch.randint(-(2**31), 2**31, (n,), generator=g,
                                   dtype=torch.int64).int().to(plane.device)
    return (cb, nsm, pm), n


@pytest.mark.parametrize("dtype,B,P,N", [
    (torch.float32, 32, 6008, 28000),   # acoustic lookup ll[b, pdf]
    (torch.int32, 32, 7000, 7000),      # trailing-silence lookup tsil[b, prev]
    (torch.float32, 1, 6008, 28000),    # the streaming recognizer's B = 1 lookups
    (torch.int32, 1, 7000, 7000),
    (torch.float32, 3, 300, 4097),      # ragged N, one past a block
    (torch.int32, 2, 20000, 999),       # row wider than the shared-memory stage
])
def test_kernel_matches_plain(cuda_device, dtype, B, P, N):
    g = torch.Generator().manual_seed(4)
    if dtype == torch.float32:
        table = torch.randn((B, P), generator=g)
    else:
        table = torch.randint(-(2**31), 2**31 - 1, (B, P), generator=g, dtype=torch.int64).int()
    idx = torch.randint(0, P, (B, N), generator=g, dtype=torch.int32)
    idx[0, 0], idx[0, 1], idx[-1, -1], idx[-1, 0] = P - 1, P, -1, -(2**31)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    ref = gather_rows_plain(table, idx)
    assert torch.equal(_bits(got), _bits(ref))  # bit-equal, out-of-range -> 0
    assert got[0, 1].item() == 0 and got[-1, -1].item() == 0


def _synthetic_rows(rng, S, M, P):
    """A packed16 arc table [S+1, 2M] with padding slots (w = +inf, next S),
    eps-flagged next states, pdf ids up to 2^14 (some past P) and row S
    all padding, as `_build_padded_tables` lays it out."""
    w = (rng.standard_normal((S + 1, M)) * 3).astype(np.float16)
    w[rng.random((S + 1, M)) < 0.2] = np.inf
    w[S] = np.inf
    pdf = rng.integers(0, min(P + 3, 1 << 14), (S + 1, M)).astype(np.uint32)
    sil = rng.integers(0, 2, (S + 1, M)).astype(np.uint32)
    sil[S] = 0
    nxt = rng.integers(0, S, (S + 1, M)).astype(np.int32)
    nxt[rng.random((S + 1, M)) < 0.1] |= 1 << 30
    nxt[np.isinf(w)] = S
    p1 = (w.view(np.uint16).astype(np.uint32) << 16) | (sil << 14) | pdf
    return torch.from_numpy(np.concatenate([p1.view(np.int32), nxt], axis=1))


@pytest.mark.parametrize("B,K,M,P,scale", [
    (32, 7000, 4, 6008, 1.0),     # the batch decoder: more blocks than SMs, ll read in place
    (1, 7000, 4, 6008, 0.7),      # a streaming recognizer: ll row bulk-copied
    (1, 7000, 4, 63, 0.7),        # odd P: no bulk copy, ll read in place
    (2, 300, 8, 63, 0.7),         # the same, one thread per candidate
    (32, 7000, 8, 6008, 1.0),     # wider rows in place
    (1, 124, 266, 6008, 1.0),     # a split graph's widest rows, staged
    (2, 100, 27, 20000, 0.7),     # P past 2^14: only the pdf range is staged
])
def test_expand_kernel_matches_plain(cuda_device, B, K, M, P, scale):
    """Each way of reading the ll row (the kernel's choice, staged, in
    place) against the plain version on the same CUDA tensors: keys
    everywhere, nsm and pm where the key is below BIG."""
    rng = np.random.default_rng(K + M)
    S = 5000
    em = _synthetic_rows(rng, S, M, P).to(cuda_device)
    state = torch.from_numpy(rng.integers(0, S + 1, (B, K)).astype(np.int32))
    state[rng.random((B, K)) < 0.3] = S
    cost = torch.from_numpy((rng.standard_normal((B, K)) * 10).astype(np.float32))
    cost[state == S] = float("inf")
    chunk = torch.from_numpy((rng.standard_normal((B, 3, P)) * 4).astype(np.float32))
    chunk[:, :, ::11] = float("-inf")
    ll = chunk.to(cuda_device)[:, 1]  # frame 1 read in place: rows strided
    state, cost = state.to(cuda_device), cost.to(cuda_device)
    mbits = max((M - 1).bit_length(), 1)
    ref = expand_v4_plain(em, state, cost, ll, scale, S, M, mbits)
    for stage in (None, *frame_step.EXPAND_STAGES):
        before = expand_v4.launches
        got = expand_v4(em, state, cost, ll, scale, S, M, mbits, stage=stage)
        torch.cuda.synchronize()
        assert expand_v4.launches == before + 1
        assert _same_pool(got, ref, stage) > 0  # dead tokens and padding arcs keyed BIG


def _synthetic_exact3_rows(rng, S, M, P):
    """An exact3 arc table [S+1, 3M] of the v4 step (f32 weight bits, next
    state, sil << pdf_bits | pdf), pdf ids up to P + 2 (some past P), with
    padding slots and row S all padding.  Returns (rows, pdf_bits)."""
    pdf_bits = (P + 2).bit_length()
    w = (rng.standard_normal((S + 1, M)) * 3).astype(np.float32)
    w[rng.random((S + 1, M)) < 0.2] = np.inf
    w[S] = np.inf
    pdf = rng.integers(0, P + 3, (S + 1, M)).astype(np.uint32)
    sil = rng.integers(0, 2, (S + 1, M)).astype(np.uint32)
    sil[S] = 0
    nxt = rng.integers(0, S, (S + 1, M)).astype(np.int32)
    nxt[rng.random((S + 1, M)) < 0.1] |= 1 << 30
    nxt[np.isinf(w)] = S
    meta = (sil << pdf_bits) | pdf
    rows = np.concatenate([w.view(np.int32), nxt, meta.view(np.int32)], axis=1)
    return torch.from_numpy(rows), pdf_bits


@pytest.mark.parametrize("B,K,M,P,scale", [
    (1, 7000, 4, 20000, 1.0),     # ll row staged whole (80 KB of shared memory)
    (3, 2000, 7, 20000, 0.7),     # one thread per candidate, staged
    (1, 7000, 4, 70000, 0.7),     # too long for shared memory: read in place
    (3, 2000, 7, 70000, 1.0),
])
def test_expand_kernel_exact3_matches_plain(cuda_device, B, K, M, P, scale):
    """The exact3 rows (pdf ids of 15 bits or more), each way of reading
    the ll row (the kernel's choice, staged, in place), against
    the plain version on the same CUDA tensors, under the pool's contract
    (`_same_pool`)."""
    rng = np.random.default_rng(K + M + P)
    S = 5000
    em, pdf_bits = _synthetic_exact3_rows(rng, S, M, P)
    em = em.to(cuda_device)
    state = torch.from_numpy(rng.integers(0, S + 1, (B, K)).astype(np.int32))
    state[rng.random((B, K)) < 0.3] = S
    cost = torch.from_numpy((rng.standard_normal((B, K)) * 10).astype(np.float32))
    cost[state == S] = float("inf")
    chunk = torch.from_numpy((rng.standard_normal((B, 2, P)) * 4).astype(np.float32))
    chunk[:, :, ::11] = float("-inf")
    ll = chunk.to(cuda_device)[:, 1]
    state, cost = state.to(cuda_device), cost.to(cuda_device)
    mbits = max((M - 1).bit_length(), 1)
    ref = expand_v4_plain(em, state, cost, ll, scale, S, M, mbits, pdf_bits)
    for stage in (None, *frame_step.EXPAND_STAGES):
        before = expand_v4.launches
        got = expand_v4(em, state, cost, ll, scale, S, M, mbits, pdf_bits, stage=stage)
        torch.cuda.synchronize()
        assert expand_v4.launches == before + 1
        assert _same_pool(got, ref, stage) > 0


@pytest.mark.parametrize("rows,B,K,M,n", [
    ("packed16", 32, 7000, 4, 4),   # the sharded batch decoder's stripes, one thread a token
    ("packed16", 1, 7000, 4, 2),    # B = 1: ll row bulk-copied
    ("packed16", 2, 301, 7, 3),     # one thread a candidate; K not a multiple of n
    ("exact3", 3, 2000, 4, 4),
    ("exact3", 3, 2000, 7, 4),
])
def test_expand_kernel_stripes_match_plain(cuda_device, rows, B, K, M, n):
    """expand_v4 over each stripe i of n of the frontier (slot_base i,
    slot_stride n, read in place) against its plain version on the same
    CUDA tensors, each way of reading the ll row, under the pool's
    contract (`_same_pool`); pm carries the global slot."""
    rng = np.random.default_rng(K + M + n)
    S, P = 5000, 6008
    if rows == "packed16":
        em, pdf_bits = _synthetic_rows(rng, S, M, P), None
    else:
        em, pdf_bits = _synthetic_exact3_rows(rng, S, M, P)
    em = em.to(cuda_device)
    state = torch.from_numpy(rng.integers(0, S + 1, (B, K)).astype(np.int32))
    state[rng.random((B, K)) < 0.3] = S
    cost = torch.from_numpy((rng.standard_normal((B, K)) * 10).astype(np.float32))
    cost[state == S] = float("inf")
    ll = torch.from_numpy((rng.standard_normal((B, 2, P)) * 4).astype(np.float32))
    ll = ll.to(cuda_device)[:, 1]
    state, cost = state.to(cuda_device), cost.to(cuda_device)
    mbits = max((M - 1).bit_length(), 1)
    for i in range(n):
        ref = expand_v4_plain(em, state, cost, ll, 1.0, S, M, mbits, pdf_bits, slot_base=i,
                              slot_stride=n)
        assert ref[0].shape == (B, len(range(i, K, n)) * M)
        for stage in (None, *frame_step.EXPAND_STAGES):
            before = expand_v4.launches
            got = expand_v4(em, state, cost, ll, 1.0, S, M, mbits, pdf_bits, stage=stage,
                            slot_base=i, slot_stride=n)
            torch.cuda.synchronize()
            assert expand_v4.launches == before + 1
            assert _same_pool(got, ref, (i, stage)) > 0


@pytest.fixture(scope="module")
def realistic_graph():
    return make_realistic_graph(num_states=20_000, num_pdfs=64, num_words=500, seed=3)


def _same_selection(cuda_device, pool, fr, valid, beam, lattice_beam, S, mbits, K2, R):
    """select_v4 against select_v4_plain on the same CUDA tensors, bit for
    bit, the records written into views of [3, B, K|R] buffers at frame 1
    and valid read as a column of a [B, 2] mask."""
    B, K = fr["state"].shape
    mask = torch.ones((B, 2), dtype=torch.bool, device=cuda_device)
    mask[:, 1] = valid
    shapes = {"pm": (torch.int32, K), "state": (torch.int32, K), "f_cost": (torch.float32, K),
              "lat_pm": (torch.int32, R), "lat_cost": (torch.float32, R)}
    bufs = [{k: torch.full((3, B, n), 7, dtype=dt, device=cuda_device)
             for k, (dt, n) in shapes.items()} for _ in range(2)]
    args = (*pool, fr, mask[:, 1], beam, lattice_beam, S, mbits, K2, R)
    before = select_v4.launches
    kf, krec = select_v4(*args, {k: v[1] for k, v in bufs[0].items()})
    torch.cuda.synchronize()
    assert select_v4.launches == before + 1
    pf, prec = select_v4_plain(*args, {k: v[1] for k, v in bufs[1].items()})
    for k in kf:
        assert torch.equal(_bits(kf[k]), _bits(pf[k])), k
        assert kf[k].data_ptr() != fr[k].data_ptr()
    for k in krec:
        assert krec[k].data_ptr() == bufs[0][k][1].data_ptr()
        assert torch.equal(_bits(krec[k]), _bits(prec[k])), k
    return pf, prec


@pytest.mark.parametrize("B,K", [(4, 256), (4, 2048), (32, 1024)])
def test_select_kernel_matches_plain_real_frames(cuda_device, realistic_graph, B, K):
    """select_v4 on real pools: a masked channel, an empty one, +inf costs."""
    dec = BatchViterbi(realistic_graph, DecodeParams(beam=10.0, max_active=K, lattice_beam=6.0),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True,
                       device=cuda_device)
    gen = torch.Generator().manual_seed(K)
    ll = torch.randn((B, 4, 64), generator=gen)
    ll[: B // 2] *= 0.2
    ll[0, 3, ::5] = float("-inf")
    ll[2, 3] = float("-inf")
    fr, _, _, _ = dec.decode_chunk(dec.init_frontier(B), ll[:, :3].to(cuda_device))
    fr["state"][-1], fr["cost"][-1] = dec.S, float("inf")
    valid = torch.ones(B, dtype=torch.bool, device=cuda_device)
    valid[1] = False
    pool = expand_v4(dec.em_pack, fr["state"], fr["cost"], ll[:, 3].to(cuda_device), 1.0,
                     dec.S, dec.M, dec.mbits)
    _same_selection(cuda_device, pool, fr, valid, 10.0, 6.0, dec.S, dec.mbits, dec.K2, dec.R)
    assert (dec.R > dec.K) == (K < 2048)


@pytest.mark.parametrize("B,K,flat", [(4, 256, False), (4, 2048, False), (32, 1024, True)])
def test_select_kernel_reads_no_payload_of_big_keys(cuda_device, realistic_graph, B, K, flat):
    """select_v4 on the expand kernel's pool with the nsm and pm of every
    BIG-keyed candidate overwritten by seeded garbage gives the frontier and
    records of select_v4_plain on the plain version's pool, bit for bit: a
    masked channel, an empty one, +inf costs; flat: every channel at
    max-active."""
    dec = BatchViterbi(realistic_graph, DecodeParams(beam=10.0, max_active=K, lattice_beam=6.0),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True,
                       device=cuda_device)
    gen = torch.Generator().manual_seed(K + B)
    T = 16 if flat else 4
    ll = torch.randn((B, T, 64), generator=gen) * (0.02 if flat else 1.0)
    ll[: B // 2] *= 0.2
    ll[0, -1, ::5] = float("-inf")
    ll[2, -1] = float("-inf")
    fr, _, _, _ = dec.decode_chunk(dec.init_frontier(B), ll[:, :-1].to(cuda_device))
    fr["state"][-1], fr["cost"][-1] = dec.S, float("inf")
    valid = torch.ones(B, dtype=torch.bool, device=cuda_device)
    valid[1] = False
    ex = (dec.em_pack, fr["state"], fr["cost"], ll[:, -1].to(cuda_device), 1.0, dec.S, dec.M,
          dec.mbits)
    ref = expand_v4_plain(*ex)
    sel = (fr, valid, 10.0, 6.0, dec.S, dec.mbits, dec.K2, dec.R)
    pf, prec = select_v4_plain(*ref, *sel, dec.record_buffers((B,)))
    for stage in frame_step.EXPAND_STAGES:
        pool, n = _overwrite_payload(expand_v4(*ex, stage=stage), seed=K + len(stage))
        assert n > 0
        kf, krec = select_v4(*pool, *sel, dec.record_buffers((B,)))
        torch.cuda.synchronize()
        for what, got, want in (("frontier", kf, pf), ("records", krec, prec)):
            for k in got:
                assert torch.equal(_bits(got[k]), _bits(want[k])), (stage, what, k)
    assert (torch.isfinite(fr["cost"]).sum(1).max() == dec.K) == flat


@pytest.mark.parametrize("K,n", [(256, 4), (2048, 2)])
def test_select_kernel_on_a_merged_pool(cuda_device, realistic_graph, K, n):
    """select_v4 on the sharded search's pool: n stripes' cost-sorted best
    SHARD_SLACK * K/n candidates within the synced beam, concatenated in
    rank order (as `viterbi_v3.shard_candidates` merges them), a pool
    narrower than K*M (and than R at K = 256)."""
    B = 4
    dec = BatchViterbi(realistic_graph, DecodeParams(beam=10.0, max_active=K, lattice_beam=6.0),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True,
                       device=cuda_device)
    gen = torch.Generator().manual_seed(K + n)
    ll = (torch.randn((B, 16, 64), generator=gen) * 0.1).to(cuda_device)
    fr, _, _, _ = dec.decode_chunk(dec.init_frontier(B), ll[:, :15])
    valid = torch.ones(B, dtype=torch.bool, device=cuda_device)
    valid[1] = False
    parts = []
    for i in range(n):
        cb, nsm, pm = expand_v4(dec.em_pack, fr["state"], fr["cost"], ll[:, 15], 1.0, dec.S,
                                dec.M, dec.mbits, slot_base=i, slot_stride=n)
        C = min(cb.shape[1], viterbi_v3.SHARD_SLACK * (K // n))
        cbs, order = torch.sort(cb, dim=1, stable=True)
        parts.append((cbs[:, :C], nsm.gather(1, order[:, :C]), pm.gather(1, order[:, :C])))
    best = torch.stack([p[0][:, 0] for p in parts]).amin(0)
    thresh = frame_step.cost_bits(frame_step.bits_cost(best) + 10.0)
    pool = [torch.cat([torch.where(p[0] <= thresh[:, None], p[0], frame_step.BIG_I32)
                       if j == 0 else p[j] for p in parts], dim=1).contiguous()
            for j in range(3)]
    assert pool[0].shape[1] == viterbi_v3.SHARD_SLACK * K < dec.K * dec.M
    _same_selection(cuda_device, pool, fr, valid, 10.0, 6.0, dec.S, dec.mbits, dec.K2, dec.R)


def _sharded_on_card(mesh, graph, ll):
    """A rank of the card test below: the sharded v4 decode of ll."""
    dec = BatchViterbi(graph, DecodeParams(beam=10.0, max_active=1024, lattice_beam=6.0),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True, device="cuda")
    fr, recs, best, bestf = dec.decode_chunk_sharded(mesh, dec.init_frontier(ll.shape[0]),
                                                     ll.cuda())
    return ({k: v.cpu() for k, v in fr.items()}, {k: v.cpu() for k, v in recs.items()},
            best.cpu(), bestf.cpu(), expand_v4.launches, select_v4.launches)


def test_sharded_decode_on_card_matches_unsharded(cuda_device, realistic_graph):
    """decode_chunk_sharded over model = 2, the ranks sharing the card over
    gloo: best, best-final, the frontier and the winners' record planes
    equal the unsharded decode's on the card, through the kernels."""
    from vosk_tpu_torch.parallel.launch import run_group

    gen = torch.Generator().manual_seed(13)
    ll = torch.randn((4, 12, 64), generator=gen) * 0.3
    res = run_group(_sharded_on_card, 1, 2, "cuda", "gloo", args=(realistic_graph, ll),
                    timeout=300)
    dec = BatchViterbi(realistic_graph, DecodeParams(beam=10.0, max_active=1024,
                                                     lattice_beam=6.0),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True, device=cuda_device)
    fr, recs, best, bestf = dec.decode_chunk(dec.init_frontier(4), ll.to(cuda_device))
    for got in res:
        gfr, grecs, gbest, gbestf, n_expand, n_select = got
        assert n_expand == n_select == 12
        assert torch.equal(_bits(gbest), _bits(best.cpu()))
        assert torch.equal(_bits(gbestf), _bits(bestf.cpu()))
        for k in fr:
            assert torch.equal(_bits(gfr[k]), _bits(fr[k].cpu())), k
        for k in ("pm", "state", "f_cost"):
            assert torch.equal(_bits(grecs[k]), _bits(recs[k].cpu())), k


def _tie_pool(rng, B, K, M, S, levels, step, n_states, pad, states=None):
    """A pool [B, K*M] as expand writes it: costs on `levels` quantised
    values (runs of equal keys across the K2 and R cuts), a share `pad` of
    padding slots (BIG, state S), next states drawn from `n_states` (or
    states(rng, B, E)); channel 1 masked, channel 2 all padding, channel 3
    all at +inf."""
    E = K * M
    q = rng.integers(0, levels, (B, E))
    cost = torch.from_numpy((q * step - 2.0).astype(np.float32))
    cb = frame_step.cost_bits(cost).numpy().copy()
    if states is None:
        nsm = rng.choice(S, n_states, replace=False)[rng.integers(0, n_states, (B, E))]
    else:
        nsm = states(rng, B, E)
    padded = rng.random((B, E)) < pad
    cb[padded], nsm[padded] = frame_step.BIG_I32, S
    valid = np.ones(B, bool)
    if B >= 4:
        valid[1] = False
        cb[2], nsm[2] = frame_step.BIG_I32, S
        cb[3] = np.where(cb[3] < frame_step.BIG_I32, 0x7F800000, cb[3])
    mbits = max((M - 1).bit_length(), 1)
    e = np.arange(E)
    pm = ((e // M) << mbits) | (e % M)
    pm = pm + (rng.integers(0, 2, (B, E)) << 30)
    return ([torch.from_numpy(np.ascontiguousarray(x, np.int32)) for x in (cb, nsm, pm)],
            torch.from_numpy(valid), mbits)


def _random_frontier(rng, B, K, S, device):
    fr = {"state": rng.integers(0, S, (B, K)).astype(np.int32),
          "cost": rng.standard_normal((B, K)).astype(np.float32),
          "tsil": rng.integers(0, 1 << 22, (B, K)).astype(np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in fr.items()}


@pytest.mark.parametrize("B,K,M,R,levels,step,n_states,pad,beams", [
    (4, 256, 4, 512, 40, 0.5, 100, 0.2, (10.0, 6.0)),       # ties across K2 = R = 512
    (4, 2048, 4, 2048, 300, 0.05, 900, 0.2, (10.0, 6.0)),   # R = K
    (4, 7000, 4, 7000, 400, 0.05, 5000, 0.2, (13.0, 6.0)),   # the decoder's K, in range
    (1, 7000, 4, 7000, 40, 0.25, 20000, 0.1, (1e3, 1e3)),   # whole pool in range: radix cut
    (2, 7000, 4, 7000, 3, 0.5, 3000, 0.0, (1e3, 1e3)),      # three runs of ~9000 equal keys
    (1, 7000, 266, 7000, 500, 0.05, 20000, 0.97, (13.0, 6.0)),  # split-graph width, padded
    (4, 124, 266, 252, 100, 0.1, 300, 0.9, (13.0, 6.0)),    # grammar shape: R > K
    # ties straddle the R cut and the K2 cut, each on its own (R = K < K2)
    (4, 7000, 4, 7000, 7, 0.5, 20000, 0.1, (1e3, 1e3)),
    # B = 3, 32 and 33: as many channels as the card holds clusters, and more
    (3, 7000, 4, 7000, 400, 0.05, 5000, 0.2, (13.0, 6.0)),
    (32, 7000, 4, 7000, 40, 0.25, 20000, 0.1, (1e3, 1e3)),
    (33, 7000, 4, 7000, 400, 0.05, 5000, 0.2, (13.0, 6.0)),
    # max-active 10,000: K2 = 20,000 ranked in global scratch
    (4, 10000, 4, 10000, 3000, 0.01, 20000, 0.2, (3.0, 2.0)),   # a narrow beam
    (1, 10000, 4, 10000, 40, 0.25, 25000, 0.1, (1e3, 1e3)),     # all in range: radix cut
])
def test_select_kernel_matches_plain_tie_heavy(cuda_device, B, K, M, R, levels, step, n_states,
                                               pad, beams):
    rng = np.random.default_rng(K + M + levels)
    S = 30000
    pool, valid, mbits = _tie_pool(rng, B, K, M, S, levels, step, n_states, pad)
    fr = _random_frontier(rng, B, K, S, cuda_device)
    pool = [x.to(cuda_device) for x in pool]
    pf, prec = _same_selection(cuda_device, pool, fr, valid.to(cuda_device), *beams, S, mbits,
                               2 * K, R)
    assert torch.isfinite(pf["cost"][0]).any() and (prec["lat_pm"][0] != -1).any()


def _colliding_states(S, n):
    """n states whose 32-bit hash (the kernel's: state * 0x9E3779B1 mod
    2^32, scaled onto the table by its top bits) lies in one of three
    windows of 2^17, so that each window's states share one or two home
    slots in any table of up to 2^15 slots."""
    s = np.arange(S, dtype=np.uint64)
    h = (s * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)
    w = np.uint64(1 << 17)
    pick = (h < w) | ((h >= np.uint64(1 << 31)) & (h < np.uint64(1 << 31) + w)) | (
        h >= np.uint64((1 << 32) - (1 << 17)))
    return np.nonzero(pick)[0][:n]


@pytest.mark.parametrize("kind", ["one_state", "distinct", "collide"])
def test_select_kernel_hash_heavy(cuda_device, kind):
    """The dedup table at its extremes: all of D on one next state, every
    candidate on its own state, and states that share their hash slots
    (long probe runs that cross the cluster's CTAs)."""
    B, K, M, S = 4, 7000, 4, 1 << 24
    same = _colliding_states(S, 1000)
    pick = {"one_state": lambda rng, b, e: np.full((b, e), 12345),
            "distinct": lambda rng, b, e: np.stack([rng.permutation(S)[:e] for _ in range(b)]),
            "collide": lambda rng, b, e: same[rng.integers(0, same.size, (b, e))]}[kind]
    rng = np.random.default_rng(len(kind))
    pool, valid, mbits = _tie_pool(rng, B, K, M, S, 400, 0.05, 0, 0.2, states=pick)
    fr = _random_frontier(rng, B, K, S, cuda_device)
    pool = [x.to(cuda_device) for x in pool]
    pf, _ = _same_selection(cuda_device, pool, fr, valid.to(cuda_device), 13.0, 6.0, S, mbits,
                            2 * K, K)
    kept = torch.isfinite(pf["cost"][0]).sum().item()
    assert kept == 1 if kind == "one_state" else kept > 900


def test_frame_step_replays_in_a_cuda_graph(cuda_device, realistic_graph):
    """One frame step (expand, then select) captured in a CUDA graph after a
    warm-up, replayed twice: bit-equal to the same step run eagerly (the
    kernels launch on the capturing stream, allocate nothing and reset
    their own counters)."""
    dec = BatchViterbi(realistic_graph, DecodeParams(beam=13.0, max_active=2048,
                                                     lattice_beam=6.0),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True, device=cuda_device)
    B = 8
    gen = torch.Generator().manual_seed(12)
    ll = (torch.randn((B, 5, 64), generator=gen) * 0.5).to(cuda_device)
    fr, _, _, _ = dec.decode_chunk(dec.init_frontier(B), ll[:, :4])
    valid = torch.ones(B, dtype=torch.bool, device=cuda_device)
    out = dec.record_buffers((B,))
    llt = ll[:, 4].contiguous()

    def step():
        return dec._frame_step_v4(fr, llt, valid, out)

    eager_f, eager_r = step()
    eager = {**{f"frontier.{k}": v.clone() for k, v in eager_f.items()},
             **{k: v.clone() for k, v in eager_r.items()}}
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        for _ in range(2):  # warm-up on the capturing stream: its scratch exists
            step()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got_f, got_r = step()
    for _ in range(2):
        for v in (*got_f.values(), *got_r.values()):
            v.fill_(-3)
        graph.replay()
        torch.cuda.synchronize()
        got = {**{f"frontier.{k}": v for k, v in got_f.items()}, **got_r}
        for k, v in eager.items():
            assert torch.equal(_bits(got[k]), _bits(v)), k
    assert torch.isfinite(eager["frontier.cost"]).sum() > B * 10


@pytest.fixture(scope="module")
def capture_decoder(realistic_graph):
    """The realistic graph's decoder at max-active 2048 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card (module docstring)")
    return BatchViterbi(realistic_graph, DecodeParams(beam=13.0, max_active=2048,
                                                      lattice_beam=6.0),
                        silence_pdfs=np.array([0, 1]), optimize_graph=True, device="cuda")


def _capture_chunks(dev, seed, B=8, T=7, n=3):
    """n chunks [B, T, 64] (flat scores on half the channels, which fill the
    frontier) and their valid masks, with holes."""
    gen = torch.Generator().manual_seed(seed)
    chunks, valid = [], []
    for _ in range(n):
        ll = torch.randn((B, T, 64), generator=gen)
        ll[: B // 2] *= 0.1
        v = torch.ones((B, T), dtype=torch.bool)
        v[1, 2:5] = False
        chunks.append(ll.to(dev))
        valid.append(v.to(dev))
    return chunks, valid


def _chained(fn, dec, chunks, valid, out=None):
    """Every chunk's (frontier, records, best, best-final) from fn over the
    chained chunks, kept to the end; out: [n, T, B, K|R] record buffers."""
    fr, kept = dec.init_frontier(chunks[0].shape[0]), []
    for i, (ll, v) in enumerate(zip(chunks, valid)):
        o = None if out is None else {k: x[i] for k, x in out.items()}
        fr, rec, best, bestf = fn(fr, ll, v, o)
        kept.append({**{f"frontier.{k}": x for k, x in fr.items()}, **rec, "best": best,
                     "best_final": bestf})
    torch.cuda.synchronize()
    return kept


def _same_chunks(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys()
        for k in b:
            assert torch.equal(_bits(a[k]), _bits(b[k])), (i, k)


@pytest.mark.parametrize("K", [2048, 1024])
def test_captured_chunks_equal_eager(cuda_device, capture_decoder, K):
    """decode_chunk replays the captured program of the chunk's shape
    (captured by a first call on other scores) and equals the eager body bit
    for bit over 3 chained chunks, records kept from every chunk and
    compared only at the end (a returned buffer that a later replay
    overwrote would show), on the decoder and on a clone at K = 1024 (its
    own program); the same with out= views of a [3, T, B, K|R] buffer.
    Each replay adds T to both launch counts and one to the replay count."""
    dec = capture_decoder if K == capture_decoder.K else capture_decoder.clone_with_max_active(K)
    assert dec.K == K and dec.graph_eligible
    chunks, valid = _capture_chunks(cuda_device, 21)
    primer, pvalid = _capture_chunks(cuda_device, 22, n=1)
    counts = frame_step.GRAPH_COUNTS
    before = (counts["captures"], len(dec._programs))
    dec.decode_chunk(dec.init_frontier(8), primer[0], pvalid[0])
    assert (counts["captures"] - before[0], len(dec._programs) - before[1]) in ((1, 1), (0, 0))
    T = chunks[0].shape[1]
    before = (expand_v4.launches, select_v4.launches, counts["replays"], counts["captures"])
    got = _chained(dec.decode_chunk, dec, chunks, valid)
    assert (expand_v4.launches - before[0], select_v4.launches - before[1],
            counts["replays"] - before[2], counts["captures"] - before[3]) == (3 * T, 3 * T, 3, 0)
    eager = _chained(dec.decode_chunk_eager, dec, chunks, valid)
    _same_chunks(got, eager)
    buf = dec.record_buffers((3, *dec.record_lead(T, 8)))
    with_out = _chained(dec.decode_chunk, dec, chunks, valid, buf)
    for i, kept in enumerate(with_out):
        for k, v in buf.items():
            assert kept[k].data_ptr() == v[i].data_ptr()
    _same_chunks(with_out, eager)
    assert torch.isfinite(eager[-1]["frontier.cost"]).sum(1).max() == K  # flat channels fill


def test_captured_chunks_from_two_threads(cuda_device, capture_decoder):
    """Two threads decode different inputs on one decoder, one of them on a
    stream of its own, 3 chained chunks 5 times each, through the shared
    program of their shape: each gets its own eager result every time."""
    dec = capture_decoder
    inputs = [_capture_chunks(cuda_device, seed) for seed in (31, 32)]
    want = [_chained(dec.decode_chunk_eager, dec, *inp) for inp in inputs]
    dec.decode_chunk(dec.init_frontier(8), inputs[0][0][0], inputs[0][1][0])  # captured
    got, errors = [[], []], []
    start = threading.Barrier(2, timeout=60)

    def worker(i):
        try:
            start.wait()
            stream = torch.cuda.Stream(cuda_device) if i else torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                for _ in range(5):
                    got[i].append(_chained(dec.decode_chunk, dec, *inputs[i]))
        except Exception as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in range(2):
        assert len(got[i]) == 5
        for run in got[i]:
            _same_chunks(run, want[i])


@pytest.fixture(scope="module")
def capture_ams():
    """The AMs whose chunks replay captured programs, on the card: a bf16
    TDNN-F (40/256/64/128/512, the bench model's 11 layers) and the same
    network exported as nnet3 with an i-vector input of dim 16 grafted onto
    its first layer (models/am.py Nnet3Am)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card (module docstring)")
    from vosk_tpu_torch.io.kaldi_export import tdnnf_to_nnet3
    from vosk_tpu_torch.models.am import Nnet3Am
    from vosk_tpu_torch.models.tdnnf import TdnnfConfig, TdnnfModel, init_params
    from vosk_tpu_torch.utils.kaldidata import graft_ivector

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TdnnfConfig(hidden_dim=256, bottleneck_dim=64, prefinal_dim=128, num_pdfs=512,
                      compute_dtype="bfloat16")
    params = init_params(cfg, seed=5)
    return {"tdnnf": TdnnfModel(cfg, params, device="cuda"),
            "nnet3": Nnet3Am(graft_ivector(tdnnf_to_nnet3(cfg, params), 16, seed=5),
                             device="cuda")}


def _am_chunks(am, B, F, seed, n=3):
    """n chunks of seeded features [B, F, D] on the card with masked tails,
    and the i-vectors [B, 16] when the AM takes them."""
    gen = torch.Generator().manual_seed(seed)
    chunks = []
    for i in range(n):
        v = torch.ones((B, F), dtype=torch.bool)
        v[1 % B, F - 3 - i:] = False
        chunks.append((torch.randn((B, F, am.feat_dim), generator=gen).cuda(), v.cuda()))
    ivec = (torch.randn((B, 16), generator=gen).cuda()
            if getattr(am, "has_ivector", False) else None)
    return chunks, ivec


def _am_chained(process, flush, am, chunks, ivec):
    """Every chunk's (state, out, out_valid), then the flush's, from
    process and flush over the chained chunks, kept to the end."""
    B, F = chunks[0][1].shape
    st, kept = am.init_stream_state(B, F), []
    for feats, valid in chunks:
        st, out, ov = process(st, feats, valid, ivec)
        kept.append({**{f"state.{k}": v for k, v in st.items()}, "out": out, "out_valid": ov})
    st, out, ov = flush(st, ivec)
    kept.append({**{f"state.{k}": v for k, v in st.items()}, "out": out, "out_valid": ov})
    torch.cuda.synchronize()
    return kept


@pytest.mark.parametrize("kind,B", [("tdnnf", 32), ("tdnnf", 4), ("nnet3", 4), ("nnet3", 32)])
def test_am_captured_chunks_equal_eager(cuda_device, capture_ams, kind, B):
    """process_chunk and flush replay the captured programs of their shapes
    (the chunk's, captured by a first call on other features, and the
    flush's [B, R + ss]) and equal the eager body bit for bit over 3 chained
    chunks and the flush: state, out and out_valid of every call, kept to
    the end (a returned tensor that a later replay overwrote would show).
    One replay a call."""
    from vosk_tpu_torch.models import streaming

    am = capture_ams[kind]
    assert am.graph_eligible
    F = 20
    chunks, ivec = _am_chunks(am, B, F, 41)
    primer, _ = _am_chunks(am, B, F, 42, n=1)
    am.process_chunk(am.init_stream_state(B, F), *primer[0], ivec)
    counts = streaming.GRAPH_COUNTS
    before = (counts["replays"], counts["captures"])
    got = _am_chained(am.process_chunk, am.flush, am, chunks, ivec)
    assert counts["replays"] - before[0] == 4 and counts["captures"] - before[1] <= 1
    want = _am_chained(am.process_chunk_eager, am._flush_impl, am, chunks, ivec)
    _same_chunks(got, want)
    shapes = {key[1:3] for key in am._programs}
    assert {(B, F), (B, am.right_context + am.subsample)} <= shapes
    assert len(am._programs) <= streaming.AM_CHUNK_PROGRAMS
    assert want[-1]["out_valid"].any() and torch.isfinite(want[-1]["out"]).all()


def test_am_captured_from_two_threads(cuda_device, capture_ams):
    """Two threads stream different inputs through one nnet3 AM (i-vectors
    included), one of them on a stream of its own, 3 chunks and a flush 5
    times each, through the shared programs of their shapes: each gets its
    own eager result every time."""
    am = capture_ams["nnet3"]
    inputs = [_am_chunks(am, 4, 20, seed) for seed in (51, 52)]
    want = [_am_chained(am.process_chunk_eager, am._flush_impl, am, *inp) for inp in inputs]
    _am_chained(am.process_chunk, am.flush, am, *inputs[0])  # captured
    got, errors = [[], []], []
    start = threading.Barrier(2, timeout=60)

    def worker(i):
        try:
            start.wait()
            stream = torch.cuda.Stream(cuda_device) if i else torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                for _ in range(5):
                    got[i].append(_am_chained(am.process_chunk, am.flush, am, *inputs[i]))
        except Exception as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in range(2):
        assert len(got[i]) == 5
        for run in got[i]:
            _same_chunks(run, want[i])


def test_am_program_eviction_waits_for_its_last_call(cuda_device, monkeypatch):
    """With room for one program, a call of a new shape evicts the last
    shape's program only once that program's last call is done on the
    device (its copy-out enqueued behind a long device sleep), and what
    that call returned stays its eager result."""
    from vosk_tpu_torch.models import streaming
    from vosk_tpu_torch.models.tdnnf import TdnnfConfig, TdnnfModel, init_params

    monkeypatch.setattr(streaming, "AM_CHUNK_PROGRAMS", 1)
    cfg = TdnnfConfig(hidden_dim=64, bottleneck_dim=16, prefinal_dim=32, num_pdfs=64)
    am = TdnnfModel(cfg, init_params(cfg, seed=6), device="cuda")
    chunks, _ = _am_chunks(am, 8, 20, 61, n=2)
    st = am.init_stream_state(8, 20)
    am.process_chunk(st, *chunks[0])  # the F = 20 program
    (key, first), = am._programs.items()
    torch.cuda._sleep(200_000_000)  # the next call's copy-out waits behind it
    got = am.process_chunk(st, *chunks[1])
    am.flush(st)  # the flush's shape: evicts F = 20
    assert first.done.query() and key not in am._programs and len(am._programs) == 1
    want = am.process_chunk_eager(st, *chunks[1])
    torch.cuda.synchronize()
    for a, b in zip((*got[0].values(), *got[1:]), (*want[0].values(), *want[1:])):
        assert torch.equal(_bits(a), _bits(b))


def test_decoder_above_shared_cap_bit_equal(cuda_device, realistic_graph):
    """max-active 10,000 on a 20,000-state graph: its K = R = 10,000 keys
    are more than select_v4 sorts in shared memory, so its second kernel
    sorts and hashes in global scratch; kernels == plain over chunks of flat scores that fill
    the frontier, on one decoder (its scratch reused across frames)."""
    dec = BatchViterbi(realistic_graph,
                       DecodeParams(beam=13.0, max_active=10000, lattice_beam=6.0),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True,
                       device=cuda_device)
    assert dec.K == 10000 and frame_step.select_in_global(dec.E, dec.K, dec.K2, dec.R)
    B, T = 2, 10
    gen = torch.Generator().manual_seed(6)
    chunks = [torch.randn((B, T, 64), generator=gen) * s for s in (0.1, 0.1, 2.0)]

    def run(ops):
        dec.step_ops = ops
        fr, outs = dec.init_frontier(B), []
        for ll in chunks:
            fr, rec, _, _ = dec.decode_chunk(fr, ll.to(cuda_device))
            outs.append({**{f"frontier.{k}": v.cpu() for k, v in fr.items()},
                         **{k: v.cpu() for k, v in rec.items()}})
        return outs

    try:
        kern = run(frame_step.KERNELS)
        plain = run(frame_step.PLAIN)
    finally:
        dec.step_ops = frame_step.KERNELS
    for a, b in zip(kern, plain):
        for k in a:
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
    assert torch.isfinite(kern[1]["frontier.cost"]).sum(1).min() > 5000  # about 8,000 live


def test_decoder_kernel_plain_and_cpu_bit_equal(cuda_device, realistic_graph):
    dec = BatchViterbi(realistic_graph,
                       DecodeParams(beam=10.0, max_active=1024, lattice_beam=6.0,
                                    acoustic_scale=0.7),
                       silence_pdfs=np.array([0, 1]), optimize_graph=True,
                       device=cuda_device)
    B, T = 16, 8
    gen = torch.Generator().manual_seed(5)
    ll = torch.randn((B, T, 64), generator=gen)
    ll[: B // 2] *= 0.2
    valid = torch.ones((B, T), dtype=torch.bool)
    valid[1, 3:5] = False

    def run(d, ops):
        d.step_ops = ops
        fr, rec, best, bestf = d.decode_chunk(d.init_frontier(B), ll.to(d.device),
                                              valid.to(d.device))
        out = {**{f"frontier.{k}": v for k, v in fr.items()}, **rec,
               "best": best, "best_final": bestf}
        return {k: v.cpu() for k, v in out.items()}

    before = (expand_v4.launches, select_v4.launches, gather_rows.launches)
    kern = run(dec, frame_step.KERNELS)
    # one call of each frame-step kernel per frame, twice on the first call
    # of a shape (the eager warm-up before the capture, then the replay);
    # no gather on the path
    assert (expand_v4.launches - before[0], select_v4.launches - before[1],
            gather_rows.launches - before[2]) == (2 * T, 2 * T, 0)
    before = (expand_v4.launches, select_v4.launches, gather_rows.launches)
    assert run(dec, frame_step.KERNELS).keys() == kern.keys()
    assert (expand_v4.launches - before[0], select_v4.launches - before[1],
            gather_rows.launches - before[2]) == (T, T, 0)
    plain = run(dec, frame_step.PLAIN)
    cpu = run(dec.to("cpu"), frame_step.KERNELS)
    for k in kern:
        assert torch.equal(_bits(kern[k]), _bits(plain[k])), k
        assert torch.equal(_bits(kern[k]), _bits(cpu[k])), k


def test_kaldi_recognizer_on_card(cuda_device, tmp_path):
    """A streaming decode whose frontier and records stay on the card, with
    the kernel launched, giving the same JSON as the same model on the CPU."""
    import json

    import vosk_tpu_torch
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.runtime import native_lattice
    from vosk_tpu_torch.utils.benchdata import make_bench_model

    native_lattice.build_library()
    m = make_bench_model(num_states=20_000, num_pdfs=64, hidden=64, max_active=1024,
                         num_words=500, compute_dtype="float32", seed=3, device="cpu")
    native.save_model(tmp_path, m.config, m.am_params, m.graph, m.words, m.phones,
                      m.phone_of_pdf, m.silence_pdfs)
    pcm = (np.random.default_rng(0).standard_normal(3 * 16000) * 500).astype("<i2").tobytes()

    def run(device):
        rec = vosk_tpu_torch.KaldiRecognizer(vosk_tpu_torch.Model(str(tmp_path), device=device),
                                             16000)
        rec.SetWords(True)
        outs, on_card = [], True
        for i in range(0, len(pcm), 6400):
            rec.AcceptWaveform(pcm[i: i + 6400])
            outs.append(rec.PartialResult())
            r = rec._rec
            on_card = on_card and r._frontier["state"].is_cuda and r._records[-1]["pm"].is_cuda
        outs.append(rec.FinalResult())
        return outs, on_card

    before = (expand_v4.launches, select_v4.launches)
    outs, on_card = run("cuda")
    assert on_card and expand_v4.launches > before[0] and select_v4.launches > before[1]
    assert "text" in json.loads(outs[-1])
    cpu_outs, _ = run("cpu")
    assert [json.loads(x).get("partial", json.loads(x).get("text")) for x in outs] == \
        [json.loads(x).get("partial", json.loads(x).get("text")) for x in cpu_outs]


def test_kaldi_dir_with_ivectors_on_card(cuda_device, tmp_path):
    """A Kaldi V2 directory written by the port's exporter (nnet3 AM with an
    i-vector input, ivector/, silence weighting) decodes on the card with
    the kernel launched and the i-vector state on the device, word for word
    as the same decode on the CPU."""
    import json

    import vosk_tpu_torch
    from vosk_tpu_torch.io.kaldi_export import export_kaldi_dir
    from vosk_tpu_torch.runtime import native_lattice
    from vosk_tpu_torch.utils import kaldidata
    from vosk_tpu_torch.utils.benchdata import make_bench_model

    native_lattice.build_library()
    m = make_bench_model(num_states=20_000, num_pdfs=64, hidden=64, max_active=1024,
                         num_words=500, seed=3, device="cpu")
    kaldidata.one_phone_per_pdf(m)
    ivcfg = kaldidata.make_ivector_config(m.am_config.feat_dim, num_gauss=32, ubm_dim=20,
                                          ivector_dim=16, seed=3)
    export_kaldi_dir(m, tmp_path / "plain")
    kaldidata.write_ivector_kaldi_dir(m, tmp_path / "plain", tmp_path / "iv", ivcfg, seed=3)
    pcm = (np.random.default_rng(1).standard_normal(4 * 16000) * 500).astype("<i2").tobytes()

    def run(device):
        rec = vosk_tpu_torch.KaldiRecognizer(
            vosk_tpu_torch.Model(str(tmp_path / "iv"), device=device), 16000)
        rec.SetWords(True)
        outs = []
        for i in range(0, len(pcm), 6400):
            rec.AcceptWaveform(pcm[i: i + 6400])
            outs.append(rec.PartialResult())
        r = rec._rec
        state_on = {k: v.device.type for k, v in r._iv_state.items()}
        outs.append(rec.FinalResult())
        return outs, r, state_on

    before = (expand_v4.launches, select_v4.launches)
    outs, r, state_on = run("cuda")
    assert expand_v4.launches > before[0] and select_v4.launches > before[1]
    assert set(state_on.values()) == {"cuda"}
    assert r._iv_frames_weighted > 0
    cpu_outs, _, _ = run("cpu")

    def words(xs):
        return [(json.loads(x).get("partial"), json.loads(x).get("text"),
                 [w["word"] for w in json.loads(x).get("result", [])]) for x in xs]

    assert words(outs) == words(cpu_outs)


@pytest.mark.parametrize("dtype,B,P,N,top,offset", [
    (torch.float32, 32, 6008, 56000, 0, 0),           # v3 acoustic lookup ll[b, pdf], M = 8
    (torch.int32, 32, 7000, 7000, 1 << 22, 0),        # tsil[b, prev], em level and eps rounds
    (torch.int32, 32, 7000, 1024, (1 << 30) - 1, 0),  # state[b, src] of an eps round
    (torch.int32, 1, 7000, 1024, (1 << 30) - 1, 0),   # the same in a B = 1 stream
    (torch.float32, 1, 6008, 4000, 0, 0),             # one tile
    (torch.float32, 32, 6008, 40000, 0, 0),           # 10 tiles: more than a cluster holds
    (torch.float32, 3, 6010, 9001, 0, 0),             # N and P not multiples of 4
    (torch.int32, 2, 7001, 9003, 1 << 22, 1),         # idx and out off 16-byte alignment
    (torch.float32, 2, 64000, 70001, 0, 0),           # row above the shared-memory opt-in
])
def test_gather_kernel_at_v3_shapes(cuda_device, dtype, B, P, N, top, offset):
    """Every way of reading the table row (the kernel's choice, in place,
    staged, multicast over a cluster of a channel's tiles) bit-equal to the
    plain version, with out-of-range indices giving 0."""
    from vosk_tpu_torch.ops.gather import GATHER_STAGES

    g = torch.Generator().manual_seed(N)
    if dtype == torch.float32:
        table = torch.randn((B, P), generator=g)
    else:
        table = torch.randint(0, top, (B, P), generator=g, dtype=torch.int32)
    idx = torch.randint(0, P, (B, N), generator=g, dtype=torch.int32)
    idx[0, 0], idx[0, 1], idx[-1, -1], idx[-1, N // 2] = P - 1, P, -1, -(2**31)
    table = table.to(cuda_device)
    # offset: a contiguous view one element into its storage
    idx = torch.cat([torch.zeros(offset, dtype=torch.int32), idx.flatten()]).to(
        cuda_device)[offset:].view(B, N)
    ref = gather_rows_plain(table, idx)
    assert ref[0, 1].item() == 0 and ref[-1, -1].item() == 0
    for stage in (None, *GATHER_STAGES):
        before = gather_rows.launches
        got = gather_rows(table, idx, stage=stage)
        torch.cuda.synchronize()
        assert gather_rows.launches == before + 1
        assert torch.equal(_bits(got), _bits(ref)), stage


def _label_eps(graph, share, seed):
    """A copy of graph with a seeded share of its eps arcs given word labels."""
    import dataclasses

    rng = np.random.default_rng(seed)
    ol = graph.eps_olabel.copy()
    hit = rng.random(len(ol)) < share
    ol[hit] = rng.integers(1, 501, int(hit.sum()))
    return dataclasses.replace(graph, eps_olabel=ol.astype(np.int32))


@pytest.mark.parametrize("graph_kind,B,K,scale,eps_budget", [
    ("raw", 16, 1024, 0.7, 1024),
    ("raw", 4, 2048, 1.0, 16),        # more eps sources than Eb
    ("labeled", 8, 1024, 1.0, 1024),  # prepared, labeled eps arcs kept: "auto" picks v3
])
def test_v3_decoder_kernel_plain_and_cpu_bit_equal(cuda_device, realistic_graph, graph_kind, B,
                                                   K, scale, eps_budget):
    """The v3 decoder with the gather kernel, with the plain gather on the
    same CUDA tensors, and on the CPU: frontier, the nine record planes and
    the best costs bit-equal; 2 + 2 * eps_iters gather launches a frame and
    no v4 kernel."""
    labeled = graph_kind == "labeled"
    graph = _label_eps(realistic_graph, 0.3, 4) if labeled else realistic_graph
    dec = BatchViterbi(graph, DecodeParams(beam=10.0, max_active=K, lattice_beam=6.0,
                                           acoustic_scale=scale),
                       silence_pdfs=np.array([0, 1]), optimize_graph=labeled,
                       device=cuda_device, frame_step="auto" if labeled else "v3")
    dec.Eb = min(dec.Eb, eps_budget)  # a small budget: more eps sources than Eb
    assert dec.frame_step == "v3" and dec.eps_iters == 2
    T = 8
    gen = torch.Generator().manual_seed(K + B)
    chunks = [torch.randn((B, T, 64), generator=gen) * s for s in (0.1, 2.0)]
    valid = torch.ones((B, T), dtype=torch.bool)
    valid[1, 3:5] = False

    def run(d, gather):
        d.gather_op = gather
        fr, outs = d.init_frontier(B), []
        for ll in chunks:
            fr, rec, best, bestf = d.decode_chunk(fr, ll.to(d.device), valid.to(d.device))
            outs.append({**{f"frontier.{k}": v for k, v in fr.items()}, **rec,
                         "best": best, "best_final": bestf})
        return [{k: v.cpu() for k, v in o.items()} for o in outs]

    before = (gather_rows.launches, expand_v4.launches, select_v4.launches)
    try:
        kern = run(dec, gather_rows)
        after = (gather_rows.launches, expand_v4.launches, select_v4.launches)
        plain = run(dec, gather_rows_plain)
    finally:
        dec.gather_op = gather_rows
    assert after[0] - before[0] == 2 * T * (2 + 2 * dec.eps_iters)
    assert after[1:] == before[1:]
    cpu = run(dec.to("cpu"), gather_rows)
    for a, b, c in zip(kern, plain, cpu):
        assert set(a) >= {"prev", "olabel", "pdf", "f_state", "f_cost", "lat_ns", "lat_prev",
                          "lat_arc", "lat_cost"}
        for k in a:
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
            assert torch.equal(_bits(a[k]), _bits(c[k])), k
    # competing tokens, and eps rounds that take eps arcs
    assert torch.isfinite(kern[0]["frontier.cost"]).sum(1).max() > 10
    assert (kern[0]["lat_arc"][:, :, 1:] >= 0).any()


@pytest.mark.parametrize("B,K,scale,budget", [
    (16, 1024, 0.7, None),
    (4, 2048, 1.0, None),
    (8, 512, 1.0, 600),       # tight budgets: arcs past them are dropped
])
def test_csr_decoder_on_card_matches_cpu(cuda_device, realistic_graph, monkeypatch, B, K,
                                         scale, budget):
    """The CSR decoder (torch ops, no hand kernel) on the card and on the
    CPU: frontier, the nine record planes and the best costs bit-equal;
    no kernel launches."""
    if budget:
        monkeypatch.setattr(viterbi, "MAX_EXPAND", budget)
    dec = BatchViterbi(realistic_graph, DecodeParams(beam=10.0, max_active=K, lattice_beam=6.0,
                                                     acoustic_scale=scale),
                       silence_pdfs=np.array([0, 1]), device=cuda_device, layout="csr")
    assert not budget or dec.E == budget
    assert (dec.layout, dec.frame_step, dec.eps_iters) == ("csr", "v3", 2)
    T = 8
    gen = torch.Generator().manual_seed(K + B)
    chunks = [torch.randn((B, T, 64), generator=gen) * s for s in (0.1, 2.0)]
    valid = torch.ones((B, T), dtype=torch.bool)
    valid[1, 3:5] = False

    def run(d):
        fr, outs = d.init_frontier(B), []
        for ll in chunks:
            fr, rec, best, bestf = d.decode_chunk(fr, ll.to(d.device), valid.to(d.device))
            outs.append({**{f"frontier.{k}": v for k, v in fr.items()}, **rec,
                         "best": best, "best_final": bestf})
        return [{k: v.cpu() for k, v in o.items()} for o in outs]

    before = (gather_rows.launches, expand_v4.launches, select_v4.launches)
    card = run(dec)
    assert (gather_rows.launches, expand_v4.launches, select_v4.launches) == before
    cpu = run(dec.to("cpu"))
    for a, c in zip(card, cpu):
        for k in a:
            assert torch.equal(_bits(a[k]), _bits(c[k])), k
    assert torch.isfinite(card[0]["frontier.cost"]).sum(1).max() > 10
    assert (card[0]["lat_arc"][:, :, 1:] >= 0).any()


def test_v3_recognizer_on_card(cuda_device, tmp_path):
    """A model directory whose graph keeps labeled eps arcs: Model +
    KaldiRecognizer take the v3 step, launch the gather kernel, keep the
    frontier and records on the card, and give the JSON the plain gather
    and the CPU give."""
    import json

    import vosk_tpu_torch
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.runtime import native_lattice
    from vosk_tpu_torch.utils.benchdata import make_bench_model

    native_lattice.build_library()
    m = make_bench_model(num_states=20_000, num_pdfs=64, hidden=64, max_active=1024,
                         num_words=500, compute_dtype="float32", seed=3, device="cpu")
    native.save_model(tmp_path, m.config, m.am_params, _label_eps(m.graph, 0.3, 5), m.words,
                      m.phones, m.phone_of_pdf, m.silence_pdfs)
    pcm = (np.random.default_rng(0).standard_normal(3 * 16000) * 500).astype("<i2").tobytes()

    def run(device, gather=None):
        model = vosk_tpu_torch.Model(str(tmp_path), device=device)
        rec = vosk_tpu_torch.KaldiRecognizer(model, 16000)
        dec = rec._rec.dec
        if gather is not None:
            dec.gather_op = gather
        rec.SetWords(True)
        outs, on_card = [], True
        for i in range(0, len(pcm), 6400):
            rec.AcceptWaveform(pcm[i: i + 6400])
            outs.append(rec.PartialResult())
            r = rec._rec
            on_card = on_card and r._frontier["state"].is_cuda and r._records[-1]["prev"].is_cuda
        outs.append(rec.FinalResult())
        return outs, on_card, dec

    before = gather_rows.launches
    outs, on_card, dec = run("cuda")
    assert dec.frame_step == "v3" and on_card and gather_rows.launches > before
    assert "text" in json.loads(outs[-1])
    assert run("cuda", gather_rows_plain)[0] == outs
    cpu_outs = run("cpu")[0]
    assert [json.loads(x).get("partial", json.loads(x).get("text")) for x in outs] == \
        [json.loads(x).get("partial", json.loads(x).get("text")) for x in cpu_outs]


def test_rnnlms_on_card_match_cpu(cuda_device, tmp_path):
    """The TDNN-LSTM Kaldi RNNLM and the GRU on the card against the same
    models on the CPU (TF32 off): logits and log-probs within 1e-4."""
    from vosk_tpu_torch.graph.fst import SymbolTable
    from vosk_tpu_torch.io.kaldi_rnnlm import KaldiRnnlmRescorer, read_rnnlm_dir
    from vosk_tpu_torch.models.rnnlm import RnnlmConfig, RnnlmModel, init_rnnlm_params
    from vosk_tpu_torch.utils import kaldidata

    torch.backends.cuda.matmul.allow_tf32 = False
    words = SymbolTable(["<eps>"] + [f"w{i}" for i in range(1, 2001)])
    kaldidata.write_kaldi_rnnlm_dir(tmp_path, words, seed=1, embedding_dim=64, cell_dim=32,
                                    recurrent_dim=16, nonrecurrent_dim=16, num_features=500,
                                    num_frequent=100)
    lm = read_rnnlm_dir(tmp_path)
    card = KaldiRnnlmRescorer(lm, device=cuda_device)
    cpu = KaldiRnnlmRescorer(lm, device="cpu")
    rng = np.random.default_rng(0)
    for k in (0, 1, 2, 3):
        st = (lm.bos,) + tuple(rng.integers(1, 2001, k).tolist())
        got, want = card.logits(st).cpu(), cpu.logits(st)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()
        assert card.score(st, 5) == (-float(got[5]), (st + (5,))[-4:])
    cfg = RnnlmConfig(vocab_size=2001, embed_dim=32, hidden_dim=48)
    params = init_rnnlm_params(cfg, seed=2)
    g_card, g_cpu = RnnlmModel(cfg, params, device=cuda_device), RnnlmModel(cfg, params, "cpu")
    h, hc = g_card.init_hidden(), g_cpu.init_hidden()
    for w in (cfg.bos, 7, 1999, 3):
        (h, lp), (hc, lpc) = g_card.step(h, w), g_cpu.step(hc, w)
        assert torch.allclose(lp.cpu(), lpc, rtol=1e-4, atol=1e-4)
    assert h.is_cuda and g_card.params["embed"].is_cuda


def _glide(seconds, B, seed):
    """B rows of a voiced signal: harmonics of an f0 gliding over 100-300 Hz
    with noise at about 10 dB SNR."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    out = []
    for b in range(B):
        f0 = 200 + 100 * np.sin(2 * np.pi * (0.3 + 0.1 * b) * t)
        ph = np.cumsum(2 * np.pi * f0 / 16000)
        x = sum(np.sin(k * ph) / k for k in range(1, 6)) * 2000
        out.append(x + rng.standard_normal(len(t)) * np.std(x) / np.sqrt(10))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("B", [1, 4])
def test_pitch_on_card_matches_cpu(cuda_device, B):
    """The MFCC + pitch extractor on the card against the CPU, streamed in
    0.2 s chunks, held as utils/pitchcheck.py states (lags equal off ties,
    POV feature 1e-3, log pitch and delta 1e-4, MFCC 1e-3); the tracker's
    state stays on the card."""
    from vosk_tpu_torch.ops.features import FeatureExtractor, FrameOptions, MelOptions, \
        MfccOptions
    from vosk_tpu_torch.utils import pitchcheck

    torch.backends.cuda.matmul.allow_tf32 = False
    opts = MfccOptions(frame_opts=FrameOptions(dither=0.0),
                       mel_opts=MelOptions(num_bins=40, low_freq=20.0, high_freq=-400.0),
                       num_ceps=40, use_energy=False)
    card = FeatureExtractor(opts, pitch_opts={}, device=cuda_device)
    cpu = FeatureExtractor(opts, pitch_opts={}, device="cpu")
    assert all(v.is_cuda for v in card.init_stream_state(B, 3200)["pitch"].values())
    audio = _glide(3.0, B, seed=B)
    stats = pitchcheck.compare(pitchcheck.stream(card, audio, 3200),
                               pitchcheck.stream(cpu, audio, 3200))
    assert stats["frames"] == B * 298 and stats["pitch_frames"] > 0


def test_xvector_on_card_matches_cpu(cuda_device, tmp_path):
    """A Kaldi x-vector dir with the VoxCeleb recipe's node graph and a
    native speaker model: the x-vector on the card against the CPU within
    1e-4 after length normalization (TF32 off)."""
    from vosk_tpu_torch.models.xvector import SpkModel, XvectorConfig, init_xvector_params
    from vosk_tpu_torch.utils import kaldidata

    torch.backends.cuda.matmul.allow_tf32 = False
    kaldidata.write_kaldi_xvector_dir(tmp_path / "kaldi", seed=1, feat_dim=30,
                                      layer_dims=(128, 128, 128, 128, 300), embed_dim=64,
                                      lda_dim=32)
    cfg = XvectorConfig(feat_dim=30, hidden_dim=64, embed_dim=32, num_layers=3)
    SpkModel(cfg, init_xvector_params(cfg, seed=2), np.zeros(32, np.float32),
             np.eye(32, dtype=np.float32), device="cpu").save(tmp_path / "native")
    feats = np.random.default_rng(3).standard_normal((400, 30)).astype(np.float32)
    for name in ("kaldi", "native"):
        card = SpkModel.load(tmp_path / name, device=cuda_device)
        cpu = SpkModel.load(tmp_path / name, device="cpu")
        got, want = card.extract(feats), cpu.extract(feats)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_step_on_card_matches_cpu(cuda_device, dtype):
    """One LF-MMI step of a small TDNN-F (models/chain.py chain_trainer, the
    loop train_chain runs) on the card against the CPU, TF32 off: f32
    products give the loss within 1e-5 and the gradients within 1e-4 of
    their largest element; bf16-rounded operands, summed in another order,
    the loss within 1e-3 and the gradient norm within 1e-2 (phase 15's
    bounds)."""
    from vosk_tpu_torch.models.chain import chain_trainer
    from vosk_tpu_torch.models.tdnnf import TdnnfConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TdnnfConfig(feat_dim=8, hidden_dim=32, bottleneck_dim=8, prefinal_dim=16,
                      num_pdfs=50, time_strides=(1, 0, 3), compute_dtype=dtype)
    rng = np.random.default_rng(13)
    feats = rng.standard_normal((6, 45, 8)).astype(np.float32)
    labels = rng.integers(0, 50, (6, 15))
    cpu = chain_trainer(cfg, feats, labels, device="cpu")
    card = chain_trainer(cfg, feats, labels, device=cuda_device)
    (lc, _), (lg, _) = cpu.step(), card.step()
    assert all(p.is_cuda for p in card.params.values())
    assert np.isfinite(float(lg))
    if dtype == "float32":
        assert float(lg) == pytest.approx(float(lc), rel=1e-5)
        for k, p in cpu.params.items():
            want = p.grad.numpy()
            np.testing.assert_allclose(card.params[k].grad.cpu().numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max() + 1e-9, err_msg=k)
    else:
        assert float(lg) == pytest.approx(float(lc), rel=1e-3)
        assert card.grad_norm() == pytest.approx(cpu.grad_norm(), rel=1e-2)
