"""vosk_tpu_torch/ops/viterbi.py against vosk_tpu/ops/viterbi.py: the v3 step.

Both decoders get the same graph and the same log-likelihoods, in two chunks
with masked frames.  The frontier (state, cost, tsil), the nine record
planes ([B, T, L, K|R]: prev, olabel, pdf, f_state, f_cost, lat_ns,
lat_prev, lat_arc, lat_cost), the best costs, `endpoint_info` and
`traceback_with_frames` must be BIT-equal.  The JAX decoder runs the padded
layout with lattice records (its gather runs its CPU route), the port on
the CPU.  Graphs: a realistic graph raw (eps rounds of depth 2), the same
graph prepared (v3 forced on an eps-free graph), the same graph with a
seeded share of its eps arcs given word labels and prepared (both pick v3
under "auto"), a copy whose olabels need the 4th row plane, and random
FSTs with labeled eps arcs (tests/test_viterbi.py).  A small eps budget
makes more eps-flagged tokens than Eb compete for the eps rounds (the tie
order of the source's top_k).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_viterbi import random_fst
from vosk_tpu.graph.fst import flatten_fst
from vosk_tpu.ops.viterbi import BatchViterbi as JViterbi, DecodeParams as JParams
from vosk_tpu.utils.benchdata import make_plausible_loglikes, make_realistic_graph
from vosk_tpu_torch.graph.fst import DecodingGraph
from vosk_tpu_torch.ops.viterbi import EPS_BUDGET, BatchViterbi, DecodeParams

SIL = np.array([0, 1], np.int32)
PLANES = {"prev", "olabel", "pdf", "f_state", "f_cost", "lat_ns", "lat_prev", "lat_arc",
          "lat_cost"}


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def label_eps_arcs(g, share, seed, num_words=500):
    """A copy of g with a seeded share of its eps arcs given word labels."""
    rng = np.random.default_rng(seed)
    ol = g.eps_olabel.copy()
    hit = rng.random(len(ol)) < share
    ol[hit] = rng.integers(1, num_words + 1, int(hit.sum()))
    return dataclasses.replace(g, eps_olabel=ol.astype(np.int32))


def wide_olabels(g, seed):
    """A copy of g whose olabels reach 2^26: they no longer fit in the meta
    plane beside 6 pdf bits, so exact3 rows carry a 4th plane."""
    rng = np.random.default_rng(seed)
    ol = g.em_olabel.copy()
    hit = (ol != 0) & (rng.random(len(ol)) < 0.5)
    ol[hit] = (1 << 26) + rng.integers(0, 1000, int(hit.sum()))
    return dataclasses.replace(g, em_olabel=ol.astype(np.int32))


@pytest.fixture(scope="module")
def realistic():
    return make_realistic_graph(num_states=20_000, num_pdfs=64, num_words=500, seed=3)


def _graph(realistic, name):
    if name == "labeled":
        return label_eps_arcs(realistic, 0.3, seed=4)
    if name == "wide_olabels":
        return wide_olabels(realistic, seed=5)
    return realistic


def _decoders(g, params, optimize, frame_step, eps_budget=1024):
    jd = JViterbi(g, JParams(**params), lattice_records=True, silence_pdfs=SIL,
                  frame_step=frame_step, layout="padded", optimize_graph=optimize,
                  eps_budget=eps_budget, **({"pack": "packed16"} if frame_step == "auto" else {}))
    td = BatchViterbi(g, DecodeParams(**params), silence_pdfs=SIL, optimize_graph=optimize,
                      device="cpu", frame_step=frame_step)
    if eps_budget != EPS_BUDGET:
        td.Eb = jd.Eb  # the source's eps_budget; the port keeps its default fixed
    assert (jd.frame_step, jd.pack, jd.K, jd.R, jd.M, jd.Eb, jd.Me, jd.eps_iters, jd.ol_in_meta) \
        == ("v3", "exact3", td.K, td.R, td.M, td.Eb, td.Me, td.eps_iters, td.ol_in_meta)
    assert td.frame_step == "v3"
    return jd, td


def _decode_both(jd, td, ll, valid, T):
    """Two chunks of T frames through both decoders, compared after each;
    returns the final frontiers and the per-chunk records."""
    B = ll.shape[0]
    jf, tf = jd.init_frontier(B), td.init_frontier(B)
    jrecs, trecs = [], []
    for c in range(ll.shape[1] // T):
        sl = slice(c * T, (c + 1) * T)
        jf, jr, jb, jbf = jd.decode_chunk(jf, ll[:, sl], valid[:, sl])
        tf, tr, tb, tbf = td.decode_chunk(tf, torch.from_numpy(ll[:, sl]),
                                          torch.from_numpy(valid[:, sl]))
        for k in ("state", "cost", "tsil"):
            np.testing.assert_array_equal(_bits(tf[k]), _bits(jf[k]), err_msg=f"frontier[{k}]")
        assert set(tr) == set(jr) == PLANES
        for k in jr:
            assert tuple(tr[k].shape) == np.asarray(jr[k]).shape, k
            np.testing.assert_array_equal(_bits(tr[k]), _bits(jr[k]), err_msg=f"records[{k}]")
        np.testing.assert_array_equal(_bits(tb), _bits(jb))
        np.testing.assert_array_equal(_bits(tbf), _bits(jbf))
        jrecs.append(jr)
        trecs.append(tr)
    return jf, tf, jrecs, trecs


def _same_host_results(jd, td, jf, tf, jrecs, trecs):
    for a, b in zip(td.endpoint_info(tf), jd.endpoint_info(jf)):
        np.testing.assert_array_equal(a, b)
    B = np.asarray(jf["state"]).shape[0]
    for ch in sorted({0, 1, B - 1}):
        for use_final in (True, False):
            assert td.traceback_with_frames(trecs, tf, ch, use_final) == \
                jd.traceback_with_frames(jrecs, jf, ch, use_final)
        # a window that does not start at utterance start (a folded stream)
        assert td.traceback_with_frames(trecs[1:], tf, ch, at_start=False) == \
            jd.traceback_with_frames(jrecs[1:], jf, ch, at_start=False)


@pytest.mark.parametrize("name,optimize,frame_step,B,K,scale,eps_budget", [
    ("raw", False, "v3", 4, 256, 1.0, 1024),
    ("raw", False, "v3", 16, 1024, 1.0, 1024),
    ("raw", False, "v3", 4, 256, 0.7, 1024),
    ("raw", False, "v3", 4, 256, 1.0, 8),          # more eps sources than Eb
    ("prepared", True, "v3", 4, 256, 0.7, 1024),   # eps-free: one level a frame
    ("labeled", True, "auto", 4, 256, 1.0, 1024),
    ("labeled", True, "auto", 16, 1024, 0.7, 16),
    ("wide_olabels", False, "v3", 4, 256, 0.7, 1024),
], ids=["raw-4-256", "raw-16-1024", "raw-4-256-scale0.7", "raw-eb8", "prepared-scale0.7",
        "labeled-4-256", "labeled-16-1024-scale0.7-eb16", "wide-olabels"])
def test_v3_bit_equal(realistic, name, optimize, frame_step, B, K, scale, eps_budget):
    g = _graph(realistic, name)
    params = dict(beam=10.0, max_active=K, lattice_beam=6.0, acoustic_scale=scale)
    jd, td = _decoders(g, params, optimize, frame_step, eps_budget)
    assert td.eps_iters == (0 if name == "prepared" else 2)
    assert td.ol_in_meta == (name != "wide_olabels")
    T = 8
    ll = make_plausible_loglikes(jd.graph, 64, B, 2 * T, seed=B).transpose(1, 0, 2)
    ll = np.ascontiguousarray(ll)
    # flat scores on half the channels fill the frontier to max-active;
    # sharp scores on the others leave a few live tokens
    ll[: B // 2] *= 0.05
    ll[B // 2:] *= 2.0
    valid = np.ones((B, 2 * T), bool)
    valid[1, 3:5] = False
    valid[0, -2:] = False
    jf, tf, jrecs, trecs = _decode_both(jd, td, ll, valid, T)

    live = np.isfinite(np.asarray(jf["cost"])).sum(axis=1)
    assert live.max() == K and live.min() < K // 4  # capped and sparse channels
    if td.eps_iters:
        # eps-flagged live tokens: more than Eb where the budget is small
        has_eps = np.diff(td.graph.eps_off) > 0
        st = np.asarray(jf["state"])
        flagged = (np.isfinite(np.asarray(jf["cost"])) & has_eps[np.minimum(st, td.S - 1)]
                   & (st < td.S)).sum(axis=1)
        assert flagged.max() > (td.Eb if eps_budget < EPS_BUDGET else 0)
        # eps rounds move tokens: some level-1+ records take an eps arc
        assert any((np.asarray(r["lat_arc"])[:, :, 1:] >= 0).any() for r in trecs)
    if name in ("labeled", "wide_olabels"):
        assert any((np.asarray(r["olabel"]) != 0).any() for r in trecs)
    _same_host_results(jd, td, jf, tf, jrecs, trecs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_v3_random_fst_labeled_eps(seed):
    """Random FSTs whose eps arcs carry words: after prepare_graph_v4 both
    packages keep the labeled eps arcs and pick v3 under "auto"."""
    g = flatten_fst(random_fst(seed, with_eps=True))
    params = dict(beam=1e9, max_active=64, lattice_beam=6.0, acoustic_scale=1.0)
    jd, td = _decoders(g, params, True, "auto")
    assert td.graph.num_eps_arcs > 0 and (td.graph.eps_olabel != 0).all()
    B, T = 3, 7
    ll = (np.random.default_rng(100 + seed).standard_normal((B, 2 * T, 8)) * 2
          ).astype(np.float32)
    valid = np.ones((B, 2 * T), bool)
    valid[2, 4:6] = False
    jf, tf, jrecs, trecs = _decode_both(jd, td, ll, valid, T)
    _same_host_results(jd, td, jf, tf, jrecs, trecs)


def _many_eps_graph(n_eps=33):
    """A 40-state chain graph whose state 0 has n_eps eps arcs."""
    S = 40
    em_off = np.arange(S + 1, dtype=np.int32)
    eps_off = np.zeros(S + 1, np.int32)
    eps_off[1:] = n_eps
    return DecodingGraph(
        num_states=S, start=0, em_off=em_off, em_pdf=np.ones(S, np.int32),
        em_olabel=np.zeros(S, np.int32), em_w=np.ones(S, np.float32),
        em_next=((np.arange(S) + 1) % S).astype(np.int32), eps_off=eps_off,
        eps_olabel=np.arange(1, n_eps + 1, dtype=np.int32),
        eps_w=np.ones(n_eps, np.float32), eps_next=np.arange(1, n_eps + 1, dtype=np.int32),
        final_cost=np.zeros(S, np.float32), eps_depth=1, max_em_out=1, max_eps_out=n_eps)


def test_v3_rejects_more_than_32_eps_arcs():
    """Above 32 eps arcs out of a state the source takes its CSR eps rounds,
    which the port does not have: it raises, naming ROADMAP A12."""
    params = DecodeParams(max_active=16)
    with pytest.raises(ValueError, match="A12"):
        BatchViterbi(_many_eps_graph(33), params, device="cpu")
    assert BatchViterbi(_many_eps_graph(32), params, device="cpu").Me == 32


@pytest.mark.parametrize("top", [(1 << 24) - 1, (1 << 30) + 5], ids=["f32-route", "i32-split"])
def test_gather_rows_equals_small_gather_routes(top):
    """The source's `_small_gather` reads state ids through an f32 one-hot
    matmul below 2^24 states and through two 16-bit halves above; the
    port's gather copies bits, so it equals whichever route the source
    takes, here with state ids up to `top`."""
    from vosk_tpu.ops.gather import onehot_gather, onehot_gather_i32
    from vosk_tpu_torch.ops.gather import gather_rows

    rng = np.random.default_rng(top % 1000)
    table = rng.integers(0, top + 1, (3, 700)).astype(np.int32)
    table[:, 0] = top
    idx = rng.integers(0, 700, (3, 256)).astype(np.int32)
    route = onehot_gather if top < (1 << 24) else onehot_gather_i32
    want = np.asarray(route(table, idx))
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.take_along_axis(table, idx, axis=1))
