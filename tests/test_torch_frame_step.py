"""vosk_tpu_torch/ops/frame_step.py against vosk_tpu/ops/viterbi.py.

The plain versions of the two frame-step kernels (what the wrappers run on
CPU tensors) must be bit-equal to the JAX decoder's `_expand_v4` (jitted,
as `decode_chunk` runs it) and `_select_v4`, on inputs taken from real
frames: dead tokens, log-likelihoods holding -inf, a masked channel, an
empty channel, +inf costs, M = 4 and wide rows, R > K and R = K.
tests/test_torch_cuda.py holds the kernels to these plain versions on the
card.
"""
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
    expand_v4, expand_v4_plain, select_tail_v4, sub_scaled,
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
    td = BatchViterbi(g, DecodeParams(**params), silence_pdfs=SIL)
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
    """The cost-ordered candidate pool of a real frame, as the source's
    one-key lax.sort leaves it."""
    cbits, nsm, pm = expand_v4_plain(td.em_pack, fr["state"], fr["cost"],
                                     torch.from_numpy(frame), 1.0, td.S, td.M, td.mbits)
    cb, order = torch.sort(cbits, dim=1, stable=True)
    return cb, torch.gather(nsm, 1, order), torch.gather(pm, 1, order)


def _select_case(g, K, B, seed):
    jd, td = _decoders(g, K)
    ll = _scores(jd.graph, 64, B, 5, seed)
    fr = _real_frontier(td, ll[:, :4])
    fr["tsil"][:, ::3] |= 5  # trailing-silence counts to carry
    # channel B-1 empty: a dead frontier, every candidate keyed BIG
    fr["state"][-1], fr["cost"][-1] = td.S, float("inf")
    frame = ll[:, 4].copy()
    frame[0, ::5] = -np.inf  # +inf costs among live candidates
    frame[2, :] = -np.inf  # every candidate of a live channel at +inf
    valid = np.ones(B, bool)
    valid[1] = False  # a masked channel
    sA = _pool(td, fr, frame)
    jfr = {k: jnp.asarray(v.numpy()) for k, v in fr.items()}
    jf, jr = jax.jit(jd._select_v4)(jfr, tuple(jnp.asarray(x.numpy()) for x in sA),
                                    jnp.asarray(valid))
    before = {k: v.clone() for k, v in fr.items()}
    tf, tr = td._select_v4(fr, sA, torch.from_numpy(valid))
    for k in ("state", "cost", "tsil"):
        _eq(tf[k].numpy(), jf[k], f"frontier[{k}]")
        assert torch.equal(fr[k], before[k]) and tf[k] is not fr[k]  # old frontier kept
    assert set(tr) == set(jr)
    for k in jr:
        _eq(tr[k].numpy(), jr[k], f"records[{k}]")
    assert (sA[0] == 0x7F800000).any() and not np.isfinite(np.asarray(jf["cost"][-1])).any()
    return td


def test_select_plain_bit_equal_r_above_k(realistic):
    td = _select_case(realistic, 256, B=4, seed=5)
    assert td.R == 512 > td.K


def test_select_plain_bit_equal_r_equal_k(realistic):
    td = _select_case(realistic, 2048, B=4, seed=6)
    assert td.R == td.K == 2048


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
    ll = torch.from_numpy(_scores(td.graph, 64, 2, 3, seed=10))
    before = (expand_v4.launches, select_tail_v4.launches)
    fk, rk, _, _ = td.decode_chunk(td.init_frontier(2), ll)
    td.step_ops = frame_step.PLAIN
    fp, rp, _, _ = td.decode_chunk(td.init_frontier(2), ll)
    assert (expand_v4.launches, select_tail_v4.launches) == before
    for k in fk:
        _eq(fp[k].numpy(), fk[k].numpy(), k)
    for k in rk:
        _eq(rp[k].numpy(), rk[k].numpy(), k)


@pytest.mark.parametrize("bad", ["ll_dtype", "ll_cols", "state_dtype", "em_cols"])
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
    else:
        args["em_pack"] = args["em_pack"][:, :3]
    with pytest.raises((TypeError, ValueError)):
        expand_v4(**args, acoustic_scale=1.0, S=td.S, M=td.M, mbits=td.mbits)


@pytest.mark.parametrize("bad", ["valid", "out_shape", "o2_dtype"])
def test_select_tail_wrapper_rejects(realistic, bad):
    _, td = _decoders(realistic, 256)
    B, K, R = 2, td.K, td.R
    fr = td.init_frontier(B)
    k2 = torch.zeros((B, td.K2), dtype=torch.int32)
    o2 = torch.zeros((B, td.K2), dtype=torch.int64)
    pool = torch.zeros((B, R), dtype=torch.int32)
    valid = torch.ones(B, dtype=torch.bool)
    out = td.record_buffers((B,))
    if bad == "valid":
        valid = valid.int()
    elif bad == "out_shape":
        out["lat_pm"] = torch.zeros((B, K), dtype=torch.int32)
    else:
        o2 = o2.int()
    with pytest.raises((TypeError, ValueError)):
        select_tail_v4(k2, o2, k2, k2, pool, pool, fr, valid, 10.0, 6.0, td.S, td.mbits, out)


def test_kernel_library_keyed_by_every_source(tmp_path, monkeypatch):
    """One library for every csrc/*.cu: its name changes with any source."""
    from vosk_tpu_torch.ops import _kernels

    names = [p.name for p in _kernels.sources()]
    assert {"frame_step.cu", "gather.cu"} <= set(names)
    for p in _kernels.sources():
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
