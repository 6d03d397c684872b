"""vosk_tpu_torch's adaptive max-active ladder (FusedPipeline.run_adaptive,
BatchViterbi.clone_with_max_active / resize_frontier / live_tokens /
traceback) against vosk_tpu's on the CPU.

Both packages build tests/test_adaptive.py's small bench model (3,000
states, 256 pdfs, max-active 512) from the same seed, with the AM's output
matrix set to zero in both: the AM then gives exact zeros, so the decoder
sees exactly the `ll_bias` scores in both packages (ll * 1e-3 + ll_bias),
and its outputs can be held bit for bit (int32 views of the f32 values).
The AMs themselves are held to each other in tests/test_torch_pipeline.py.
A run of the JAX ladder and the port's must agree in best, the final
frontier and every segment's records, on the v4 step and on the v3 step,
with the frontier unsaturated (ladder (128, 256), seg 2) and with the
ladder stepping up and down (ladder (4,), seg 1: the first segment cuts
the initial frontier to 4 slots, flat scores then flood it).  The toy
model's words through padded segment records (tests/test_wer_parity.py's
flow) must equal JAX's.  The mesh cases run in gloo ranks
(parallel/launch.py `run_group`, as tests/test_torch_multichip.py does): a
spawned rank imports this module, so jax and vosk_tpu are imported inside
the fixtures and tests that use them.
"""
import sys

import numpy as np
import pytest
import torch

from vosk_tpu_torch.ops import frame_step as fs
from vosk_tpu_torch.ops.viterbi import BatchViterbi
from vosk_tpu_torch.parallel.launch import run_group
from vosk_tpu_torch.runtime.pipeline import ADAPTIVE_HEADROOM, FusedPipeline
from vosk_tpu_torch.utils import benchdata

MODEL = dict(num_states=3000, num_pdfs=256, max_active=512, realistic=True, num_words=500,
             seed=3)
P = MODEL["num_pdfs"]
B, N_CHUNKS = 2, 4
B_MESH = 4     # the (2, 1) mesh's global batch: two channels a data rank
TIMEOUT = 240


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b, what):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _silent_am(m):
    """m with its AM's output matrix zeroed: the AM then gives exact zeros."""
    m.am_params = {**m.am_params, "output_w": np.zeros_like(m.am_params["output_w"])}
    return m


@pytest.fixture(scope="module")
def models():
    from vosk_tpu.utils import benchdata as j_bench

    return (_silent_am(j_bench.make_bench_model(**MODEL)),
            _silent_am(benchdata.make_bench_model(device="cpu", **MODEL)))


def _audio(seed, batch=B, n=N_CHUNKS):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, batch, 3200)) * 300).astype(np.float32)


def _scores(tp, kinds, seed, batch=B):
    """ll_bias [n, batch, T, P]: chunk i of kind kinds[i], "easy"
    (make_plausible_loglikes at snr 8.0, as tests/test_adaptive.py), "clear"
    (snr 16.0: below 128 live tokens in every frame here) or "flat"
    (N(0, 0.1^2): every arc within the beam, so max-active fills); kinds
    may also be one list a channel.  (A chunk's scores reach the frontier
    a chunk later, behind the AM's right context.)"""
    per_channel = kinds if isinstance(kinds[0], (list, tuple)) else [kinds] * batch
    T, n = tp.T, len(per_channel[0])
    by_kind = {k: benchdata.make_plausible_loglikes(
        tp.model.graph, P, batch, n * T, snr=snr, seed=seed).reshape(n, T, batch, P).swapaxes(1, 2)
        for k, snr in (("easy", 8.0), ("clear", 16.0))}
    by_kind["flat"] = np.random.default_rng(seed + 1).standard_normal(by_kind["easy"].shape) * 0.1
    out = np.empty(by_kind["easy"].shape, np.float32)
    for b, ks in enumerate(per_channel):
        for i, k in enumerate(ks):
            out[i, b] = by_kind[k][i, b]
    return out


def _rungs(recs):
    return [int(r["pm"].shape[-1] if "pm" in r else r["prev"].shape[-1]) for r in recs]


@pytest.fixture(scope="module")
def pipes(models):
    """{frame_step: (JAX pipeline, port pipeline)}, records on."""
    from vosk_tpu.runtime.pipeline import FusedPipeline as JFused

    jm, tm = models
    out = {}
    for step in ("v4", "v3"):
        jp = JFused(jm, batch=B, lattice_records=True, frame_step=step)
        tp = FusedPipeline(tm, batch=B, frame_step=step)
        assert jp.dec.frame_step == tp.dec.frame_step == step
        out[step] = (jp, tp)
    return out


# ------------------------------------------------------- the decoder methods


@pytest.mark.parametrize("k", [4, 64, 128, 256])
@pytest.mark.parametrize("step", ["v4", "v3"])
def test_clone_fields_match_jax(pipes, step, k):
    """K, E, K2, R, Eb, params.max_active and the initial closure equal the
    JAX clone's; every device table is the parent's own tensor (the same
    storage: nothing re-uploaded), with a fresh lock and kernel scratch."""
    jp, tp = pipes[step]
    jc, tc = jp.dec.clone_with_max_active(k), tp.dec.clone_with_max_active(k)
    for f in ("K", "E", "K2", "R", "Eb"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.params.max_active == jc.params.max_active == k
    assert tp.dec.params.max_active == MODEL["max_active"]
    _eq(tc._init_states, jc._init_states, "init states")
    _eq(tc._init_costs, jc._init_costs, "init costs")
    assert tc._init_prefixes == jc._init_prefixes
    shared = [n for n in ("em_pack", "eps_pack", "_final_cost_t", "eps_off", "eps_next")
              if hasattr(tp.dec, n)]
    assert "em_pack" in shared and "_final_cost_t" in shared
    for n in shared:
        assert getattr(tc, n).data_ptr() == getattr(tp.dec, n).data_ptr(), n
    assert tc.dense_w is tp.dec.dense_w and tc.dense_olabel is tp.dec.dense_olabel
    assert tc._dispatch_lock is not tp.dec._dispatch_lock
    assert tc._select_scratch is not tp.dec._select_scratch
    assert tc.step_ops is tp.dec.step_ops


def test_clone_r_is_the_source_clones(pipes):
    """The clone takes R = min(max(K, min(2048, E)), E), the source clone's
    formula, where __init__ also caps R at K + Ee, and keeps its parent's
    Ee: on the prepared (eps-free) graph a fresh decoder at max-active 128
    has Ee = 128 and R = 256, the clone of the 512 decoder R = E = 512, as
    the JAX clone."""
    from vosk_tpu_torch.ops.viterbi import DecodeParams

    jp, tp = pipes["v4"]
    d = tp.dec
    fresh = BatchViterbi(d.graph, DecodeParams(**{**vars(d.params), "max_active": 128}),
                         silence_pdfs=d.silence_pdfs, device="cpu")
    clone = d.clone_with_max_active(128)
    assert (fresh.K, fresh.E, fresh.Ee, fresh.R) == (128, 512, 128, 256)
    assert (clone.E, clone.Ee, clone.R) == (512, d.Ee, 512)
    assert clone.R == jp.dec.clone_with_max_active(128).R


def test_clone_refuses_csr(models):
    from vosk_tpu_torch.ops.viterbi import DecodeParams

    tm = models[1]
    dec = BatchViterbi(tm.graph, DecodeParams(max_active=64), device="cpu", layout="csr")
    with pytest.raises(ValueError, match="padded"):
        dec.clone_with_max_active(16)


@pytest.mark.parametrize("k_new", [64, 512, 700])
def test_resize_frontier_matches_jax(pipes, k_new):
    """Truncation and growth of a frontier after 2 chunks of flat scores
    equal JAX's resize_frontier; grown slots are dead."""
    jp, tp = pipes["v4"]
    dec = tp.dec
    ll = np.random.default_rng(4).standard_normal((B, 12, P)).astype(np.float32) * 0.1
    fr, *_ = dec.decode_chunk(dec.init_frontier(B), torch.from_numpy(ll))
    assert dec.live_tokens(fr).min() == dec.K  # overflowing
    got = dec.resize_frontier(fr, k_new)
    want = jp.dec.resize_frontier({k: np.asarray(v) for k, v in fr.items()}, k_new)
    for k in ("state", "cost", "tsil"):
        assert got[k].shape == (B, k_new) and got[k].is_contiguous()
        _eq(got[k], want[k], f"resize {k}")
    if k_new > dec.K:
        assert (got["state"][:, dec.K:] == dec.S).all()
        assert not torch.isfinite(got["cost"][:, dec.K:]).any()
    np.testing.assert_array_equal(dec.live_tokens(got),
                                  jp.dec.live_tokens({k: np.asarray(v) for k, v in got.items()}))


def test_select_leaves_frontier_sorted_by_cost(pipes):
    """Truncating keeps the best tokens only because select leaves the slots
    sorted by cost: the frontier costs select_v4_plain returns do not
    decrease along the slots, on a frontier loaded to overflowing (flat
    scores: every channel's pool far past max-active within the beam)."""
    dec = pipes["v4"][1].dec
    ll = np.random.default_rng(6).standard_normal((B, 16, P)).astype(np.float32) * 0.1
    fr = dec.init_frontier(B)
    for t in range(ll.shape[1]):
        cands = fs.expand_v4_plain(dec.em_pack, fr["state"], fr["cost"],
                                   torch.from_numpy(ll[:, t]), dec.params.acoustic_scale, dec.S,
                                   dec.M, dec.mbits, None)
        out = {k: v[0] for k, v in dec.record_buffers((1, B)).items()}
        fr, _ = fs.select_v4_plain(*cands, fr, torch.ones(B, dtype=torch.bool),
                                   dec.params.beam, dec.params.lattice_beam, dec.S, dec.mbits,
                                   dec.K2, dec.R, out)
        c = fr["cost"]
        assert (c[:, 1:] >= c[:, :-1]).all(), t
    assert (torch.isfinite(fr["cost"]).sum(1) == dec.K).all()
    assert (cands[0] < fs.BIG_I32).sum(1).min() > dec.K2  # the pool overflowed the cut


def test_live_tokens_and_traceback_match_jax(pipes):
    """live_tokens is the per-channel finite count; traceback drops the
    frame indices of traceback_with_frames, as the source's."""
    jp, tp = pipes["v4"]
    dec = tp.dec
    ll = np.random.default_rng(5).standard_normal((B, 6, P)).astype(np.float32) * 2
    fr, rec, _, _ = dec.decode_chunk(dec.init_frontier(B), torch.from_numpy(ll))
    jfr, jrec, _, _ = jp.dec.decode_chunk(jp.dec.init_frontier(B), ll)
    np.testing.assert_array_equal(dec.live_tokens(fr), jp.dec.live_tokens(jfr))
    for b in range(B):
        got = dec.traceback([rec], fr, b)
        assert got == jp.dec.traceback([jrec], jfr, b)
        cost, olf, pdfs = dec.traceback_with_frames([rec], fr, b)
        assert got == (cost, [o for o, _ in olf], pdfs)


# ------------------------------------------------------------ run_adaptive


CASES = {
    # ladder, seg, kinds of the 4 chunks, audio seed
    "unsaturated": ((128, 256), 2, ["clear"] * 4, 0),
    "steps_up_and_down": ((4,), 1, ["easy", "flat", "flat", "easy", "easy", "easy"], 1),
}


def _run_both(pipes, step, case):
    jp, tp = pipes[step]
    ladder, seg, kinds, seed = CASES[case]
    jp.adaptive_ladder = tp.adaptive_ladder = ladder
    jp._adaptive_decs = tp._adaptive_decs = None
    audio, lb = _audio(seed, n=len(kinds)), _scores(tp, kinds, seed)
    j = jp.run_adaptive(jp.init_state(), audio, ll_bias=lb, seg=seg)
    t = tp.run_adaptive(tp.init_state(), audio, ll_bias=lb, seg=seg)
    return j, t, (audio, lb, seg)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("step", ["v4", "v3"])
def test_run_adaptive_matches_jax(pipes, step, case):
    """The port's run_adaptive against JAX's on the same scores: best, the
    final frontier and every segment's records bit-equal, segment by
    segment at the same rungs.  "unsaturated": every segment at the
    smallest rung (128).  "steps_up_and_down": the initial frontier cut to
    4 slots, the flat chunks step up to the full 512, the easy ones bring
    it back down to 4 (a truncation of a loaded frontier), and a segment
    that fills 4 steps up again."""
    (js, jrecs, jbest), (ts, trecs, tbest), (audio, _, seg) = _run_both(pipes, step, case)
    n = audio.shape[0]
    assert tbest.shape == (n, B) and torch.isfinite(tbest).all()
    _eq(tbest, jbest, "best")
    for k in ("state", "cost", "tsil"):
        _eq(ts["frontier"][k], js["frontier"][k], f"frontier[{k}]")
    rungs = _rungs(trecs)
    assert rungs == _rungs([{k: np.asarray(v) for k, v in r.items()} for r in jrecs])
    assert len(trecs) == -(-n // seg)
    for i, (a, b) in enumerate(zip(trecs, jrecs)):
        assert set(a) == set(b)
        for k in a:
            assert tuple(a[k].shape) == np.asarray(b[k]).shape, (i, k)
            _eq(a[k], b[k], f"segment {i} records[{k}]")
    if case == "unsaturated":
        assert rungs == [128, 128]
    else:
        assert rungs == [4, 4, 512, 512, 4, 512], rungs


def test_run_adaptive_equals_run_scan_unsaturated(pipes):
    """Where the frontier stays below the smallest rung, run_adaptive is the
    fixed-K run_scan: best bit-equal, the final frontier grown back to K
    bit-equal, the K-wide record planes of every frame equal to the fixed
    run's first 128 slots (the rest dead there), and the same tracebacks (words and alignment) from records
    of different widths."""
    _, tp = pipes["v4"]
    tp.adaptive_ladder, tp._adaptive_decs = (128, 256), None
    audio, lb = _audio(0), _scores(tp, ["clear"] * 4, 0)
    fs_, frecs, fbest = tp.run_scan(tp.init_state(), audio, ll_bias=lb)
    as_, arecs, abest = tp.run_adaptive(tp.init_state(), audio, ll_bias=lb, seg=2)
    # the premise: below the smallest rung in every frame of the fixed run
    assert int(torch.isfinite(frecs["f_cost"]).sum(-1).max()) < 128
    _eq(abest, fbest, "best")
    grown = tp.dec.resize_frontier(as_["frontier"], tp.dec.K)
    for k in grown:
        _eq(grown[k], fs_["frontier"][k], f"frontier[{k}]")
    for i, r in enumerate(arecs):
        for k in ("pm", "state", "f_cost"):
            _eq(r[k], frecs[k][2 * i:2 * i + 2, ..., :128], f"segment {i} {k}")
    assert not torch.isfinite(frecs["f_cost"][..., 128:]).any()
    flat = [{k: v.reshape(-1, *v.shape[2:]) for k, v in r.items()} for r in arecs]
    fixed = [{k: v.reshape(-1, *v.shape[2:]) for k, v in frecs.items()}]
    for b in range(B):
        assert tp.dec.traceback(flat, as_["frontier"], b) == \
            tp.dec.traceback(fixed, fs_["frontier"], b)


def test_run_adaptive_first_rung_from_incoming_frontier(pipes):
    """A carried frontier whose live count passes the smallest rung's
    headroom starts at a larger rung, as the source reads the incoming
    frontier: after 2 flat chunks the next call starts at the full K."""
    jp, tp = pipes["v4"]
    tp.adaptive_ladder, tp._adaptive_decs = (4,), None
    jp.adaptive_ladder, jp._adaptive_decs = (4,), None
    audio, lb = _audio(2), _scores(tp, ["flat"] * 4, 2)
    st, _, _ = tp.run_scan(tp.init_state(), audio[:2], ll_bias=lb[:2])
    jst, _, _ = jp.run_scan(jp.init_state(), audio[:2], ll_bias=lb[:2])
    _, recs, best = tp.run_adaptive(st, audio[2:], ll_bias=lb[2:], seg=1)
    _, jrecs, jbest = jp.run_adaptive(jst, audio[2:], ll_bias=lb[2:], seg=1)
    assert _rungs(recs)[0] == tp.dec.K
    _eq(best, jbest, "best")


# ---------------------------------------------------------------- toy model


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    from vosk_tpu.utils import toydata

    path = str(tmp_path_factory.mktemp("toy") / "model")
    toydata.build_toy_model(path, train_steps=400)
    return path


def test_toy_model_traceback_over_segments_matches_jax(toy_dir):
    """tests/test_wer_parity.py's flow on the toy model: run_adaptive (seg
    4, the default ladder below the toy's max-active 2000), each segment's
    records flattened to frames and padded to the full K, the frontier
    grown to K, then traceback: the same words as JAX's, as the port's
    fixed run_scan, and as the port's traceback over the unpadded segments
    of different widths."""
    import vosk_tpu
    import vosk_tpu_torch
    from vosk_tpu.runtime.pipeline import FusedPipeline as JFused
    from vosk_tpu.utils import toydata

    jn = vosk_tpu.Model(toy_dir)._model
    tn = vosk_tpu_torch.Model(toy_dir, device="cpu")._model
    jp = JFused(jn, batch=1, collect_records=True, lattice_records=True)
    tp = FusedPipeline(tn, batch=1)
    assert tp.adaptive_ladder == jp.adaptive_ladder == (1024, 2048, 4096)
    S, K, Sent = tp.chunk_samples, tp.dec.K, tp.dec.S

    def flat(r):
        return {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:]) for k, v in r.items()}

    def pad_k(r):
        fill = {"pm": -1, "state": Sent, "f_cost": np.inf, "lat_pm": -1, "lat_cost": np.inf}
        return {k: np.concatenate([v, np.full(v.shape[:-1] + (K - v.shape[-1],), fill[k],
                                              v.dtype)], -1) if v.shape[-1] < K else v
                for k, v in r.items()}

    words = {"jax": [], "port": [], "port_ragged": [], "port_fixed": []}
    rungs = []
    for i, ws in enumerate([["one", "three", "five", "seven"], ["two", "zero", "six", "four"]]):
        wav = toydata.make_test_wav(ws, seed=900 + i)
        n = -(-len(wav) // S) * S
        audio = np.zeros(n, np.float32)
        audio[:len(wav)] = wav
        audio = audio.reshape(-1, 1, S)
        jst, jrecs, _ = jp.run_adaptive(jp.init_state(), audio, seg=4)
        _, jols, _ = jp.dec.traceback([pad_k(flat(r)) for r in jrecs],
                                      jp.dec.resize_frontier(jst["frontier"], K), 0)
        tst, trecs, _ = tp.run_adaptive(tp.init_state(), audio, seg=4)
        rungs.append(_rungs(trecs))
        _, tols, _ = tp.dec.traceback([pad_k(flat(r)) for r in trecs],
                                      tp.dec.resize_frontier(tst["frontier"], K), 0)
        _, rols, _ = tp.dec.traceback([{k: v.reshape(-1, *v.shape[2:]) for k, v in r.items()}
                                       for r in trecs], tst["frontier"], 0)
        fst, frecs, _ = tp.run_scan(tp.init_state(), audio)
        _, fols, _ = tp.dec.traceback([flat(frecs)], fst["frontier"], 0)
        for key, ols, names in (("jax", jols, jn.words), ("port", tols, tn.words),
                                ("port_ragged", rols, tn.words),
                                ("port_fixed", fols, tn.words)):
            words[key].append([names.name(o) for o in ols])
    assert words["port"] == words["jax"] == words["port_ragged"] == words["port_fixed"], words
    assert any(len(w) for w in words["port"])
    assert all(r and set(r) <= {1024, K} for r in rungs)


# --------------------------------------------------------------------- mesh


def _mesh_rank(mesh, audio, lb):
    """run_adaptive on this rank's channels of the global batch, with a
    ladder of (64,) and seg 1; and the rung each data half would take alone
    from its own live count."""
    from vosk_tpu_torch.parallel import mesh as pm

    pipe = FusedPipeline(_silent_am(benchdata.make_bench_model(device="cpu", **MODEL)),
                         batch=B_MESH, mesh=mesh)
    pipe.adaptive_ladder = (64,)
    st, recs, best = pipe.run_adaptive(pipe.init_state(), audio, ll_bias=lb, seg=1)
    return {"jax_loaded": "jax" in sys.modules, "rungs": _rungs(recs),
            "best": pm.gather_channels(mesh, best, dim=1),
            "frontier": pm.gather_channels(mesh, st["frontier"]),
            "records": [pm.gather_channels(mesh, r, dim=2) for r in recs]}


def test_run_adaptive_mesh_takes_the_global_rung(models):
    """run_adaptive on a (2, 1) mesh, whose two data halves see different
    scores (channels 0-1 clear throughout, channels 2-3 flat in chunks 1-2),
    so that each half alone would take another rung at some boundary: every
    rank takes the rung of the global batch's live count, and best, the
    final frontier and every segment's records equal the unsharded run's bit
    for bit."""
    tm = models[1]
    tp = FusedPipeline(tm, batch=B_MESH)
    tp.adaptive_ladder = (64,)
    kinds = [["clear"] * 6] * 2 + [["easy", "flat", "flat", "easy", "easy", "easy"]] * 2
    audio = _audio(3, B_MESH, len(kinds[0]))
    lb = _scores(tp, kinds, 3, B_MESH)
    st, recs, best = tp.run_adaptive(tp.init_state(), audio, ll_bias=lb, seg=1)
    # the rung each half would take alone, from the unsharded run's segments
    halves = []
    for half in (slice(0, 2), slice(2, 4)):
        h = [tp.dec.init_frontier(2)] + [
            {"cost": r["f_cost"][-1, -1, half]} for r in recs[:-1]]
        halves.append([64 if tp.dec.live_tokens(f).max() <= ADAPTIVE_HEADROOM * 64 else tp.dec.K
                       for f in h])
    assert halves[0] != halves[1]  # a local choice would differ
    res = run_group(_mesh_rank, 2, 1, "cpu", args=(audio, lb), timeout=TIMEOUT)
    assert not any(r["jax_loaded"] for r in res)
    assert res[0]["rungs"] == res[1]["rungs"] == _rungs(recs)
    assert _rungs(recs) == [max(a, b) for a, b in zip(*halves)]
    _eq(res[0]["best"], best, "best")
    for k in st["frontier"]:
        _eq(res[0]["frontier"][k], st["frontier"][k], f"frontier[{k}]")
    for i, (a, b) in enumerate(zip(res[0]["records"], recs)):
        for k in b:
            _eq(a[k], b[k], f"segment {i} records[{k}]")
