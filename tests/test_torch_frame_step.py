"""vosk_tpu_torch/ops/frame_step.py against vosk_tpu/ops/viterbi.py.

The plain versions of the two frame-step kernels (what the wrappers run on
CPU tensors) must be bit-equal to the JAX decoder's `_expand_v4` (jitted,
as `decode_chunk` runs it) and its pool sort + `_select_v4`, on inputs
taken from real frames: dead tokens, log-likelihoods holding -inf, a
masked channel, an empty channel, +inf costs, M = 4 and wide rows, R > K
and R = K.  The selection is also stated here in numpy without a sort of
the pool (order statistics, a per-state minimum, ranks of the survivors),
which is how the select_v4 kernel computes it, and held to the JAX
function on tie-heavy synthetic pools.  tests/test_torch_cuda.py holds the
kernels to these plain versions on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_arrayopt import random_fst_unlabeled_eps
from vosk_tpu.graph.arrayopt import prepare_graph_v4 as j_prepare
from vosk_tpu.graph.fst import flatten_fst
from vosk_tpu.ops.viterbi import BatchViterbi as JViterbi, DecodeParams as JParams
from vosk_tpu.utils.benchdata import make_plausible_loglikes, make_realistic_graph
from vosk_tpu_torch.ops import frame_step
from vosk_tpu_torch.ops.frame_step import (
    expand_v4, expand_v4_plain, select_v4, select_v4_plain, sub_scaled,
)
from vosk_tpu_torch.ops.viterbi import BatchViterbi, DecodeParams

SIL = np.array([0, 1], np.int32)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b, what):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


@pytest.fixture(scope="module")
def realistic():
    """The 20k-state realistic graph after prepare_graph_v4 (M = 4)."""
    g = make_realistic_graph(num_states=20_000, num_pdfs=64, num_words=500, seed=3)
    return j_prepare(g, M=4)


@pytest.fixture(scope="module")
def wide():
    """A small graph whose out-degree stays at 27 after prepare_graph_v4."""
    g = j_prepare(flatten_fst(random_fst_unlabeled_eps(2)), M=4)
    assert g.max_em_out == 27 and g.num_eps_arcs == 0
    return g


def _decoders(g, K, scale=1.0, padded_max_out=16):
    params = dict(beam=10.0, max_active=K, lattice_beam=6.0, acoustic_scale=scale)
    jd = JViterbi(g, JParams(**params), lattice_records=True, silence_pdfs=SIL,
                  frame_step="v4", pack="packed16", padded_max_out=padded_max_out)
    td = BatchViterbi(g, DecodeParams(**params), silence_pdfs=SIL, device="cpu")
    assert (jd.K, jd.R, jd.M, jd.mbits) == (td.K, td.R, td.M, td.mbits)
    return jd, td


def _scores(g, P, B, T, seed):
    """[B, T, P] plausible scores: flat on the first half of the channels
    (the frontier fills to max-active), sharp on the others."""
    ll = np.ascontiguousarray(
        make_plausible_loglikes(g, P, B, T, seed=seed).transpose(1, 0, 2))
    ll[: B // 2] *= 0.2
    ll[B // 2:] *= 2.0
    return ll


def _real_frontier(td, ll):
    """The port's frontier after decoding ll [B, T, P] (bit-equal to the
    JAX decoder's, tests/test_torch_viterbi.py)."""
    fr, _, _, _ = td.decode_chunk(td.init_frontier(ll.shape[0]), torch.from_numpy(ll))
    return fr


# ----------------------------------------------------------------- repair


@pytest.mark.parametrize("scale", [0.7, 1.0, 0.1])
def test_sub_scaled_is_the_fused_multiply_add(scale):
    """(t + w) - scale * ac rounded once, as jitted JAX computes it."""
    rng = np.random.default_rng(7)
    n = 1 << 16
    t = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    w = (rng.standard_normal(n) * 3).astype(np.float32)
    ac = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3, n)).astype(np.float32)
    t[:3], ac[:3] = [np.inf, 1.0, 5.0], [2.0, -np.inf, np.inf]
    ref = np.asarray(jax.jit(lambda a, b, c: a + b - scale * c)(t, w, ac))
    got = sub_scaled(torch.from_numpy(t) + torch.from_numpy(w), scale, torch.from_numpy(ac))
    _eq(got.numpy(), ref, f"scale {scale}")
    assert np.isposinf(ref[:2]).all() and np.isneginf(ref[2])
    if scale != 1.0:  # separate roundings differ, which is the fault repaired
        sep = (torch.from_numpy(t) + torch.from_numpy(w) - scale * torch.from_numpy(ac))
        assert (_bits(sep.numpy()) != _bits(ref)).sum() > 0


# ----------------------------------------------------------------- expand


def _expand_case(g, K, scale, B, P, seed, padded_max_out=16):
    jd, td = _decoders(g, K, scale, padded_max_out)
    ll = _scores(jd.graph, P, B, 6, seed)
    fr = _real_frontier(td, ll[:, :5])
    state, cost = fr["state"].clone(), fr["cost"].clone()
    state[0, -3:], cost[0, -3:] = td.S, float("inf")  # dead tokens
    frame = ll[:, 5].copy()
    frame[0, ::7] = -np.inf  # candidates whose cost is +inf
    frame[-1, :] = -np.inf
    ref = jax.jit(jd._expand_v4)(jnp.asarray(state.numpy()), jnp.asarray(cost.numpy()),
                                  jnp.asarray(frame))
    got = expand_v4_plain(td.em_pack, state, cost, torch.from_numpy(frame), scale,
                          td.S, td.M, td.mbits)
    for name, a, b in zip(("cbits", "nsm", "pm"), got, ref):
        _eq(a.numpy(), b, name)
    dead = (state == td.S).repeat_interleave(td.M, dim=1)
    assert dead.any() and (got[0][dead] == frame_step.BIG_I32).all()
    assert (got[0] == 0x7F800000).any()  # +inf costs reached the keys
    return td, got


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_expand_plain_bit_equal_m4(realistic, scale):
    td, _ = _expand_case(realistic, 256, scale, B=4, P=64, seed=1)
    assert td.M == 4


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_expand_plain_bit_equal_wide_rows(wide, scale):
    td, _ = _expand_case(wide, 16, scale, B=4, P=6, seed=2, padded_max_out=64)
    assert td.M == 27


def test_expand_plain_reads_strided_ll(realistic):
    """A frame of a [B, T, P] chunk read in place equals its copy."""
    _, td = _decoders(realistic, 256)
    ll = torch.from_numpy(_scores(td.graph, 64, 3, 4, seed=4))
    fr = td.init_frontier(3)
    a = expand_v4(td.em_pack, fr["state"], fr["cost"], ll[:, 2], 0.7, td.S, td.M, td.mbits)
    b = expand_v4(td.em_pack, fr["state"], fr["cost"], ll[:, 2].contiguous(), 0.7,
                  td.S, td.M, td.mbits)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ----------------------------------------------------------------- select


def _pool(td, fr, frame):
    """The unsorted candidate pool of a real frame, as expand leaves it."""
    return expand_v4_plain(td.em_pack, fr["state"], fr["cost"], torch.from_numpy(frame), 1.0,
                           td.S, td.M, td.mbits)


def _jax_select(jd, fr, pool, valid):
    """The source's pool sort and `_select_v4`, jitted as `decode_chunk`
    runs them."""
    def f(fr, pool, valid):
        return jd._select_v4(fr, jax.lax.sort(pool, num_keys=1, dimension=1), valid)

    jf, jr = jax.jit(f)({k: jnp.asarray(np.asarray(v)) for k, v in fr.items()},
                        tuple(jnp.asarray(np.asarray(x)) for x in pool), jnp.asarray(valid))
    return {k: np.asarray(v) for k, v in jf.items()}, {k: np.asarray(v) for k, v in jr.items()}


def _port_select(td, fr, pool, valid):
    B = fr["state"].shape[0]
    before = {k: v.clone() for k, v in fr.items()}
    tf, tr = select_v4(*pool, fr, torch.from_numpy(valid), td.params.beam,
                       td.params.lattice_beam, td.S, td.mbits, td.K2, td.R,
                       td.record_buffers((B,)))
    for k in fr:
        assert torch.equal(fr[k], before[k]) and tf[k] is not fr[k]  # old frontier kept
    return {k: v.numpy() for k, v in tf.items()}, {k: v.numpy() for k, v in tr.items()}


def _same(a, b, what):
    assert set(a[1]) == set(b[1])
    for k in a[0]:
        _eq(a[0][k], b[0][k], f"{what} frontier[{k}]")
    for k in a[1]:
        _eq(a[1][k], b[1][k], f"{what} records[{k}]")


def _select_inputs(td, ll):
    """(frontier, frame, valid) from scores ll [B, T, P]: the frontier after
    T - 1 frames, then a dead channel, +inf costs and a masked channel."""
    B = ll.shape[0]
    fr = _real_frontier(td, ll[:, :-1])
    fr["tsil"][:, ::3] |= 5  # trailing-silence counts to carry
    # channel B-1 empty: a dead frontier, every candidate keyed BIG
    fr["state"][-1], fr["cost"][-1] = td.S, float("inf")
    frame = ll[:, -1].copy()
    frame[0, ::5] = -np.inf  # +inf costs among live candidates
    frame[2, :] = -np.inf  # every candidate of a live channel at +inf
    valid = np.ones(B, bool)
    valid[1] = False  # a masked channel
    return fr, frame, valid


def _select_case(g, K, B, seed):
    jd, td = _decoders(g, K)
    fr, frame, valid = _select_inputs(td, _scores(jd.graph, 64, B, 5, seed))
    pool = _pool(td, fr, frame)
    j = _jax_select(jd, fr, pool, valid)
    _same(_port_select(td, fr, pool, valid), j, "plain")
    _same(_spec_select(td, fr, pool, valid), j, "numpy statement")
    assert (pool[0] == 0x7F800000).any() and not np.isfinite(j[0]["cost"][-1]).any()
    return td


def test_select_plain_bit_equal_r_above_k(realistic):
    td = _select_case(realistic, 256, B=4, seed=5)
    assert td.R == 512 > td.K


def test_select_plain_bit_equal_r_equal_k(realistic):
    td = _select_case(realistic, 2048, B=4, seed=6)
    assert td.R == td.K == 2048


def _exact3_graph(g, top=20_000, seed=11):
    """g with its 64 pdf ids sent to distinct seeded ids below `top` (top - 1
    among them), so that the v4 step runs on exact3 rows.  Returns (graph,
    map)."""
    rng = np.random.default_rng(seed)
    pmap = np.append(np.sort(rng.choice(top - 1, 63, replace=False)), top - 1).astype(np.int32)
    return dataclasses.replace(g, em_pdf=pmap[g.em_pdf]), pmap


def _overwrite_payload(pool, seed):
    """The pool with the nsm and pm of every candidate keyed BIG replaced by
    seeded garbage: the words the expand kernel leaves unwritten (nsm and pm
    are defined where cbits < BIG).  Returns (pool, words overwritten a
    plane)."""
    cb, nsm, pm = (x.clone() for x in pool)
    big = cb == frame_step.BIG_I32
    n = int(big.sum())
    rng = np.random.default_rng(seed)
    for plane in (nsm, pm):
        plane[big] = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    return (cb, nsm, pm), n


PAYLOAD_CASES = {  # name: (graph fixture, K, P, frames, the scores' scale)
    "light_r_above_k": ("realistic", 256, 64, 5, None),
    "light_r_equal_k": ("realistic", 2048, 64, 5, None),
    "loaded": ("realistic", 256, 64, 16, 0.02),  # live channels at max-active
    "wide_rows": ("wide", 16, 6, 5, None),
    "exact3": ("realistic", 256, 20_000, 5, None),
}


@pytest.mark.parametrize("case", list(PAYLOAD_CASES))
def test_select_plain_reads_no_payload_of_big_keys(request, case):
    """The expand kernel writes nsm and pm only where cbits < BIG.  With the
    payload of every BIG-keyed candidate of expand_v4_plain's pool
    overwritten by seeded garbage, select_v4_plain must give what the JAX
    package's jitted pool sort + `_select_v4` gives on the clean pool, bit
    for bit, on _select_case's frames (a dead channel, padded arcs, +inf
    costs, a masked channel), light and loaded, on wide rows (M > 4) and on
    exact3 rows."""
    fixture, K, P, T, scale = PAYLOAD_CASES[case]
    g = base = request.getfixturevalue(fixture)
    pmap = None
    if case == "exact3":
        g, pmap = _exact3_graph(base)
    jd, td = _decoders(g, K, padded_max_out=64 if fixture == "wide" else 16)
    B = 4
    if pmap is None:
        ll = _scores(jd.graph, P, B, T, seed=K + P)
    else:  # plausible scores at the mapped pdf ids, seeded noise elsewhere
        ll = (np.random.default_rng(K).standard_normal((B, T, P)) - 12.0).astype(np.float32)
        ll[:, :, pmap] = _scores(base, 64, B, T, seed=K)
    if scale is not None:
        ll *= scale
    fr, frame, valid = _select_inputs(td, ll)
    pool = expand_v4_plain(td.em_pack, fr["state"], fr["cost"], torch.from_numpy(frame),
                           td.params.acoustic_scale, td.S, td.M, td.mbits,
                           td.pdf_bits if td.pack == "exact3" else None)
    want = _jax_select(jd, fr, pool, valid)
    garbled, n = _overwrite_payload(pool, seed=len(case))
    assert n > 0 and not torch.equal(garbled[1], pool[1]) and not torch.equal(garbled[2], pool[2])
    got = select_v4_plain(*garbled, fr, torch.from_numpy(valid), td.params.beam,
                          td.params.lattice_beam, td.S, td.mbits, td.K2, td.R,
                          td.record_buffers((B,)))
    _same(({k: v.numpy() for k, v in got[0].items()}, {k: v.numpy() for k, v in got[1].items()}),
          want, case)
    assert td.M == (27 if fixture == "wide" else 4)
    assert td.pack == ("exact3" if pmap is not None else "packed16")
    live = (fr["state"] != td.S).sum(1)
    assert (live[0] == td.K) == (case == "loaded")
    # the garbage reached candidates of live channels, not only the dead one
    assert (pool[0][:-1] == frame_step.BIG_I32).any()


# ------------------------------------------------ select in numpy, no sort


def _cost_bits(c):
    cb = np.asarray(c, np.float32).view(np.int32).astype(np.int64)
    return np.where(cb < 0, -(2**31) - cb, cb).astype(np.int32)


def _bits_cost(k):
    k = np.asarray(k, np.int64)
    return np.where(k < 0, -(2**31) - k, k).astype(np.int32).view(np.float32)


def _spec_select(td, fr, pool, valid):
    """What select computes, stated without a sort of the pool.  Per
    channel, over the 64-bit key (cbits, e): D is the K2 smallest keys (an
    order statistic); each next state's winner is its smallest key in D;
    the winners ranked by (cbits, state) fill the frontier within the beam
    from the best winner; the lattice rows are the R smallest keys, kept
    within wk + lattice_beam of the worst finite kept winner wk."""
    BIG, S, K, R, mbits = frame_step.BIG_I32, td.S, td.K, td.R, td.mbits
    beam = np.float32(td.params.beam)
    lb = np.float32(td.params.lattice_beam)
    cb, nsm, pm = (np.asarray(x) for x in pool)
    st, co, ts = (np.asarray(fr[k]) for k in ("state", "cost", "tsil"))
    B, E = cb.shape
    K2 = min(E, td.K2)
    nf = {"state": np.full((B, K), S, np.int32), "cost": np.full((B, K), np.inf, np.float32),
          "tsil": np.zeros((B, K), np.int32)}
    rec = {"pm": np.full((B, K), -1, np.int32), "lat_pm": np.full((B, R), -1, np.int32),
           "lat_cost": np.full((B, R), np.inf, np.float32)}
    slot = np.arange(K, dtype=np.int32)
    for b in range(B):
        if not valid[b]:  # the old frontier, identity records
            nf["state"][b], nf["cost"][b], nf["tsil"][b] = st[b], co[b], ts[b]
            rec["pm"][b] = frame_step.PM_IDENT_FLAG | (slot << mbits)
            n = min(K, R)
            rec["lat_pm"][b, :n] = rec["pm"][b, :n]
            rec["lat_cost"][b, :n] = co[b, :n]
            continue
        key = ((cb[b].astype(np.int64) + 2**31).astype(np.uint64) << np.uint64(32)) | \
            np.arange(E, dtype=np.uint64)
        in_d = key <= np.partition(key, K2 - 1)[K2 - 1]
        live = in_d & (cb[b] < BIG) & (nsm[b] != S)
        states, inv = np.unique(nsm[b][live], return_inverse=True)
        wmin = np.full(states.size, np.iinfo(np.uint64).max)
        np.minimum.at(wmin, inv, key[live])
        w_cb = ((wmin >> np.uint64(32)).astype(np.int64) - 2**31).astype(np.int32)
        rank = np.lexsort((states, w_cb))[:K]  # the survivors only
        w_cb, w_n = w_cb[rank], states[rank]
        w_e = (wmin[rank] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        keep = np.zeros(0, bool)
        if w_cb.size:
            thr = _cost_bits(_bits_cost(w_cb[0]) + beam)
            keep = w_cb <= thr
        n = int(keep.sum())  # keep is a prefix: w_cb ascends
        p = pm[b, w_e[:n]]
        prev = (p & frame_step.PM_MASK) >> mbits
        pts = np.where(prev < K, ts[b, np.minimum(prev, K - 1)], 0)
        sil = (p & frame_step.PM_SIL_FLAG) != 0
        nf["state"][b, :n] = w_n[:n]
        nf["cost"][b, :n] = _bits_cost(w_cb[:n])
        nf["tsil"][b, :n] = np.where(
            sil, ((pts & frame_step.TSIL_MASK) + 1) | (pts & frame_step.SPEECH_BIT),
            frame_step.SPEECH_BIT)
        rec["pm"][b, :n] = p & frame_step.PM_MASK
        kc = nf["cost"][b, :n]
        fin = kc[np.isfinite(kc)]
        wk = fin.max() if fin.size else np.float32(-np.inf)
        nr = min(R, E)
        rows = np.sort(key[key <= np.partition(key, nr - 1)[nr - 1]])  # the R survivors
        r_cb = ((rows >> np.uint64(32)).astype(np.int64) - 2**31).astype(np.int32)
        r_e = (rows & np.uint64(0xFFFFFFFF)).astype(np.int64)
        r_cost = _bits_cost(r_cb)
        lkeep = (r_cb < BIG) & (r_cost <= np.float32(wk + lb))
        rec["lat_pm"][b, :nr] = np.where(lkeep, pm[b, r_e] & frame_step.PM_MASK, -1)
        rec["lat_cost"][b, :nr] = np.where(lkeep, r_cost, np.inf)
    rec["state"], rec["f_cost"] = nf["state"].copy(), nf["cost"].copy()
    return nf, rec


def _tie_pool(rng, td, B, E, levels, step, n_states):
    """A synthetic pool [B, E] as expand writes it: costs on `levels`
    quantised values (long runs of equal keys), a fifth of the slots
    padding (BIG, state S), next states drawn from `n_states`, pm words with
    prev < K and random silence flags.  Channel 1 is masked, channel 2 all
    padding, channel 3 all at +inf."""
    q = rng.integers(0, levels, (B, E))
    cb = _cost_bits((q * step - 2.0).astype(np.float32))
    nsm = rng.choice(td.S, n_states, replace=False)[rng.integers(0, n_states, (B, E))]
    pad = rng.random((B, E)) < 0.2
    cb[pad], nsm[pad] = frame_step.BIG_I32, td.S
    cb[2], nsm[2] = frame_step.BIG_I32, td.S
    cb[3] = np.where(cb[3] < frame_step.BIG_I32, 0x7F800000, cb[3])
    e = np.arange(E)
    pm = ((e % td.K) << td.mbits) | (e // td.K % (1 << td.mbits))
    pm = pm + (rng.integers(0, 2, (B, E)) << 30)
    valid = np.ones(B, bool)
    valid[1] = False
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32)) for x in (cb, nsm, pm)), valid


@pytest.mark.parametrize("K,E,levels,step,n_states", [
    (256, 1024, 40, 0.5, 100),    # runs of ~20 equal keys straddle the K2 = R = 512 cuts
    (256, 1024, 4, 0.5, 30),      # every state has candidates in D and past it
    (256, 256, 12, 1.5, 60),      # a pool smaller than K2 (and R), as at M = 1
    (2048, 8192, 300, 0.05, 900),  # R = K = 2048, K2 = 4096
    (256, 2048, 2000, 0.001, 400),  # a run past the beam, few ties
    # R = K = 2048 < K2 = 4096: runs of ~330 equal keys straddle both cuts
    (2048, 8192, 20, 0.05, 900),
    (2048, 8192, 20, 0.05, 8),    # and all of D falls on 8 states
    (256, 1024, 40, 0.5, 8),      # K2 = R = 512 on 8 states
])
def test_select_spec_bit_equal_on_tie_heavy_pools(realistic, K, E, levels, step, n_states):
    jd, td = _decoders(realistic, K)
    rng = np.random.default_rng(K + E + levels)
    pool, valid = _tie_pool(rng, td, 4, E, levels, step, n_states)
    fr = td.init_frontier(4)
    fr["state"] = torch.from_numpy(rng.integers(0, td.S, (4, td.K)).astype(np.int32))
    fr["cost"] = torch.from_numpy(rng.standard_normal((4, td.K)).astype(np.float32))
    fr["tsil"] = torch.from_numpy(rng.integers(0, 1 << 22, (4, td.K)).astype(np.int32))
    j = _jax_select(jd, fr, pool, valid)
    _same(_spec_select(td, fr, pool, valid), j, "numpy statement")
    _same(_port_select(td, fr, pool, valid), j, "plain")
    assert np.isfinite(j[0]["cost"][0]).any()
    assert np.isposinf(j[0]["cost"][2]).all() and (j[1]["lat_pm"][3] == -1).all()


def test_wide_rows_decode_bit_equal(wide):
    """Whole chunks on the wide graph: frontier and records as the JAX
    decoder's v4 step with padded_max_out=64."""
    jd, td = _decoders(wide, 16, 0.7, padded_max_out=64)
    rng = np.random.default_rng(8)
    ll = (rng.standard_normal((3, 10, 6)) * 2).astype(np.float32)
    valid = np.ones((3, 10), bool)
    valid[1, 4:6] = False
    jf, jr, jb, _ = jd.decode_chunk(jd.init_frontier(3), ll, valid)
    tf, tr, tb, _ = td.decode_chunk(td.init_frontier(3), torch.from_numpy(ll),
                                    torch.from_numpy(valid))
    for k in ("state", "cost", "tsil"):
        _eq(tf[k].numpy(), jf[k], f"frontier[{k}]")
    for k in jr:
        _eq(tr[k].numpy(), jr[k], f"records[{k}]")
    _eq(tb.numpy(), jb, "best")


# ------------------------------------------------------------- wrappers


def test_decode_chunk_writes_into_out_views(realistic):
    _, td = _decoders(realistic, 256)
    ll = torch.from_numpy(_scores(td.graph, 64, 2, 6, seed=9))
    fr0 = td.init_frontier(2)
    f1, r1, b1, bf1 = td.decode_chunk(fr0, ll)
    big = td.record_buffers((3, 6, 2))
    f2, r2, b2, bf2 = td.decode_chunk(fr0, ll, out={k: v[1] for k, v in big.items()})
    for k in r1:
        assert r2[k].data_ptr() == big[k][1].data_ptr()
        _eq(big[k][1].numpy(), r1[k].numpy(), k)
    for k in f1:
        _eq(f2[k].numpy(), f1[k].numpy(), k)
    _eq(b2.numpy(), b1.numpy(), "best")
    _eq(bf2.numpy(), bf1.numpy(), "best final")


def test_cpu_tensors_use_plain_and_count_no_launch(realistic):
    _, td = _decoders(realistic, 256)
    assert td.step_ops == frame_step.KERNELS
    assert frame_step.PLAIN == (expand_v4_plain, select_v4_plain)
    ll = torch.from_numpy(_scores(td.graph, 64, 2, 3, seed=10))
    before = (expand_v4.launches, select_v4.launches)
    fk, rk, _, _ = td.decode_chunk(td.init_frontier(2), ll)
    td.step_ops = frame_step.PLAIN
    fp, rp, _, _ = td.decode_chunk(td.init_frontier(2), ll)
    assert (expand_v4.launches, select_v4.launches) == before
    for k in fk:
        _eq(fp[k].numpy(), fk[k].numpy(), k)
    for k in rk:
        _eq(rp[k].numpy(), rk[k].numpy(), k)


@pytest.mark.parametrize("bad", ["ll_dtype", "ll_cols", "state_dtype", "em_cols", "stage"])
def test_expand_wrapper_rejects(realistic, bad):
    _, td = _decoders(realistic, 256)
    fr = td.init_frontier(2)
    args = dict(em_pack=td.em_pack, tok_state=fr["state"], tok_cost=fr["cost"],
                ll=torch.zeros((2, 64)))
    if bad == "ll_dtype":
        args["ll"] = args["ll"].double()
    elif bad == "ll_cols":
        args["ll"] = torch.zeros((64, 2)).t()
    elif bad == "state_dtype":
        args["tok_state"] = args["tok_state"].long()
    elif bad == "em_cols":
        args["em_pack"] = args["em_pack"][:, :3]
    else:
        args["stage"] = "staged"  # the gather's name; expand's is "bulk"
    with pytest.raises((TypeError, ValueError)):
        expand_v4(**args, acoustic_scale=1.0, S=td.S, M=td.M, mbits=td.mbits)


@pytest.mark.parametrize("bad", ["valid", "out_shape", "nsm_dtype", "pm_cols"])
def test_select_wrapper_rejects(realistic, bad):
    _, td = _decoders(realistic, 256)
    B = 2
    fr = td.init_frontier(B)
    pool = [torch.zeros((B, td.E), dtype=torch.int32) for _ in range(3)]
    valid = torch.ones(B, dtype=torch.bool)
    out = td.record_buffers((B,))
    if bad == "valid":
        valid = valid.int()
    elif bad == "out_shape":
        out["lat_pm"] = torch.zeros((B, td.K), dtype=torch.int32)
    elif bad == "nsm_dtype":
        pool[1] = pool[1].long()
    else:
        pool[2] = pool[2][:, :-1]
    with pytest.raises((TypeError, ValueError)):
        select_v4(*pool, fr, valid, 10.0, 6.0, td.S, td.mbits, td.K2, td.R, out)


@pytest.mark.parametrize("K,K2,R,in_global", [
    (256, 512, 512, False), (8192, 16384, 7000, False), (10000, 20000, 10000, True),
    (8192, 16384, 8193, True), (4096, 16385, 4096, True)])
def test_select_scratch_sizes_and_reuse(K, K2, R, in_global):
    """select_v4's scratch: pass 1's counters set once (BIG, 0) and its
    list [B * E] of int32 candidate numbers; pass 2's global buffers (a row
    of bucket keys per CTA, hash keys and values) only past SELECT_SORT_CAP
    keys a sort or SELECT_TABLE_CAP slots, at the kernel's sizes; reused per
    (device, stream) and grown, never shrunk."""
    sc = frame_step.SelectScratch()
    dev = torch.device("cpu")
    B, E = 3, 40000
    buf = sc.buffers(dev, 7, B, E, K, K2, R)
    assert torch.equal(buf["best"], torch.full((B,), frame_step.BIG_I32, dtype=torch.int32))
    assert torch.equal(buf["count"], torch.zeros(B, dtype=torch.int32))
    assert buf["list"].numel() == B * E and buf["list"].dtype == torch.int32
    assert frame_step.select_in_global(E, K, K2, R) == in_global
    slots = frame_step.select_table_slots(E, K2)
    assert slots == max(1024, -(-5 * K2 // 4))  # at most 4/5 full
    if in_global:
        cap = -(-max(K, R) // 256) * 256
        C = frame_step.SELECT_MAX_CLUSTER
        assert (buf["s"].numel(), buf["tk"].numel(), buf["tv"].numel()) == (
            B * C * cap, B * (slots + C), B * (slots + C))
        assert buf["tk"].dtype == torch.int32 and buf["tv"].dtype == torch.int64
    else:
        assert all(buf[k] is None for k in ("s", "tk", "tv"))
    assert frame_step.SelectScratch.nbytes(B, E, K, K2, R) == sum(
        v.numel() * v.element_size() for v in buf.values() if v is not None)
    same = sc.buffers(dev, 7, 2, E, K, K2, R)
    for k, v in buf.items():
        assert (v is None and same[k] is None) or v.data_ptr() == same[k].data_ptr(), k
    grown = sc.buffers(dev, 7, 4, E, K, K2, R)
    assert grown["list"].numel() == 4 * E and grown["best"].numel() == 4
    assert sc.buffers(dev, 8, B, E, K, K2, R)["list"].data_ptr() != grown["list"].data_ptr()


def test_decoder_owns_its_select_scratch(realistic):
    """Each decoder keeps its own select_v4 scratch, freed with it; a copy
    on another device gets a new one."""
    _, td = _decoders(realistic, 256)
    assert isinstance(td._select_scratch, frame_step.SelectScratch)
    assert td.to("cpu")._select_scratch is not td._select_scratch


def test_entry_points_default_to_the_card():
    """The port's public constructors run on the card unless asked for the
    CPU (read from their signatures; nothing is built)."""
    import inspect

    from vosk_tpu_torch.models.am import Nnet3Am
    from vosk_tpu_torch.models.tdnnf import TdnnfModel, tdnnf_params_from_jax
    from vosk_tpu_torch.ops.features import FeatureExtractor
    from vosk_tpu_torch.ops.ivector import OnlineIvectorExtractor

    for fn in (BatchViterbi, Nnet3Am, TdnnfModel, tdnnf_params_from_jax, FeatureExtractor,
               OnlineIvectorExtractor):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_kernel_library_keyed_by_every_source(tmp_path, monkeypatch):
    """One library for every csrc/*.cu: its name changes with any source,
    and with any header they share (csrc/*.cuh), which nvcc is not given
    as a source."""
    from vosk_tpu_torch.ops import _kernels

    names = [p.name for p in _kernels.sources() + _kernels.headers()]
    assert {"frame_step.cu", "gather.cu", "stage.cuh"} <= set(names)
    assert all(p.suffix == ".cu" for p in _kernels.sources())
    for p in _kernels.sources() + _kernels.headers():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_kernels, "_CSRC", tmp_path)
    first = _kernels.library_path()
    assert first.name.startswith("libvt_kernels-") and first.suffix == ".so"
    for name in names:
        src = tmp_path / name
        src.write_bytes(src.read_bytes() + b"\n")
        assert _kernels.library_path() != first, name
        src.write_bytes(src.read_bytes()[:-1])
    assert _kernels.library_path() == first
