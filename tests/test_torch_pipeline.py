"""vosk_tpu_torch FusedPipeline (step, run_scan, the ll_bias hook) against
vosk_tpu's on the CPU.

Both packages build the same small bench model from a seed (realistic
graph, f32 TDNN-F, lattice records on) and take the same audio: best costs
must agree within 1e-4 plus 1e-6 relative (raw AM scores sum to costs of
hundreds, whose float32 spacing is 3e-5 to 6e-5, and the two AMs round
differently), and the decoded-frame counts exactly.
"""
import numpy as np
import pytest
import torch

from vosk_tpu.runtime.pipeline import FusedPipeline as JFused
from vosk_tpu.utils import benchdata as j_bench
from vosk_tpu_torch.runtime.pipeline import FusedPipeline
from vosk_tpu_torch.utils import benchdata

B, N_CHUNKS, CHUNK_S = 3, 3, 0.48
MODEL = dict(num_states=3000, num_pdfs=48, hidden=32, max_active=256,
             compute_dtype="float32", seed=1, num_words=200)


@pytest.fixture(scope="module")
def pipes():
    jm = j_bench.make_bench_model(realistic=True, **MODEL)
    tm = benchdata.make_bench_model(device="cpu", **MODEL)
    jp = JFused(jm, batch=B, chunk_seconds=CHUNK_S, lattice_records=True)
    tp = FusedPipeline(tm, batch=B, chunk_seconds=CHUNK_S)
    return jp, tp


@pytest.fixture(scope="module")
def audio(pipes):
    rng = np.random.default_rng(2)
    return (rng.standard_normal((N_CHUNKS, B, pipes[1].chunk_samples)) * 500
            ).astype(np.float32)


def _bias(tp, seed):
    """bench.py's ll_bias: plausible scores [n_chunks, B, T, P]."""
    P = tp.model.am_config.num_pdfs
    lb = benchdata.make_plausible_loglikes(tp.model.graph, P, B, N_CHUNKS * tp.T,
                                           snr=2.0, seed=seed)
    return np.ascontiguousarray(lb.reshape(N_CHUNKS, tp.T, B, P).swapaxes(1, 2))


def test_step_matches_jax(pipes, audio):
    jp, tp = pipes
    js, ts = jp.init_state(), tp.init_state()
    n = np.array([audio.shape[2], audio.shape[2] // 3, 0], np.int32)
    for i in range(N_CHUNKS):
        js, jrec, jbest, jbestf, jframes = jp.step(js, audio[i], n if i == 1 else None)
        ts, trec, tbest, tbestf, tframes = tp.step(ts, audio[i], n if i == 1 else None)
        np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
        np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(tbestf.numpy(), np.asarray(jbestf), rtol=1e-6, atol=1e-4)
        assert trec["pm"].shape == tuple(np.asarray(jrec["pm"]).shape) == (tp.T, B, tp.dec.K)
        assert trec["lat_cost"].shape == tuple(np.asarray(jrec["lat_cost"]).shape)
    assert int(tframes.sum()) > 0 and np.isfinite(tbest.numpy()).all()


@pytest.mark.parametrize("bias_seed", [None, 0])
def test_run_scan_matches_jax(pipes, audio, bias_seed):
    jp, tp = pipes
    lb = None if bias_seed is None else _bias(tp, bias_seed)
    _, jrecs, jbest = jp.run_scan(jp.init_state(), audio, ll_bias=lb)
    st, trecs, tbest = tp.run_scan(tp.init_state(), audio, ll_bias=lb)
    assert tbest.shape == (N_CHUNKS, B)
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), rtol=1e-6, atol=1e-4)
    for k, v in trecs.items():
        assert v.shape == tuple(np.asarray(jrecs[k]).shape), k
    assert np.isfinite(tbest.numpy()).all()
    if lb is not None:  # plausible scores keep competing tokens alive
        assert int(torch.isfinite(trecs["f_cost"]).sum(-1).max()) > 1


def test_run_scan_equals_steps_and_drops_records(pipes, audio):
    """run_scan is the step loop with preallocated records; without
    collect_records it returns none and the same best costs."""
    _, tp = pipes
    lb = _bias(tp, 5)
    _, recs, best = tp.run_scan(tp.init_state(), audio, ll_bias=lb)
    st = tp.init_state()
    n = torch.full((B,), audio.shape[2], dtype=torch.int32)
    for i in range(N_CHUNKS):
        st, rec, b, _, _ = tp._step_impl(st, torch.from_numpy(audio[i]), n,
                                         torch.from_numpy(lb[i]))
        assert torch.equal(b, best[i])
        for k in rec:
            assert torch.equal(rec[k], recs[k][i]), k
    bare = FusedPipeline(tp.model, batch=B, chunk_seconds=CHUNK_S, collect_records=False)
    _, none, best2 = bare.run_scan(bare.init_state(), audio, ll_bias=lb)
    assert none is None and torch.equal(best2, best)


@pytest.fixture(scope="module")
def v3_pipes(pipes):
    """Both packages' pipelines with frame_step="v3": the raw graph, eps
    rounds and all."""
    jp, tp = pipes
    return (JFused(jp.model, batch=B, chunk_seconds=CHUNK_S, lattice_records=True,
                   frame_step="v3"),
            FusedPipeline(tp.model, batch=B, chunk_seconds=CHUNK_S, frame_step="v3"))


def test_run_scan_v3_matches_jax(v3_pipes, audio):
    """run_scan with the v3 step: records in the source's [n_chunks, B, T,
    L, K|R] layout, the planes and shapes of the JAX run_scan and best costs
    within the AM tolerance; and every record bit-equal to the JAX v3
    decoder's on the port's own scores, chunk by chunk."""
    from vosk_tpu.ops.viterbi import BatchViterbi as JViterbi, DecodeParams as JParams

    jp, tp = v3_pipes
    dec = tp.dec
    assert dec.frame_step == jp.dec.frame_step == "v3" and dec.eps_iters == 2
    assert dec.S == tp.model.graph.num_states  # the raw graph
    lb = _bias(tp, 3)
    _, jrecs, jbest = jp.run_scan(jp.init_state(), audio, ll_bias=lb)
    _, trecs, tbest = tp.run_scan(tp.init_state(), audio, ll_bias=lb)
    L = 1 + dec.eps_iters
    assert set(trecs) == set(jrecs)
    for k, v in trecs.items():
        n = dec.R if k.startswith("lat_") else dec.K
        assert v.shape == tuple(np.asarray(jrecs[k]).shape) == (N_CHUNKS, B, tp.T, L, n), k
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), rtol=1e-6, atol=1e-4)

    c = tp.model.config
    jd = JViterbi(tp.model.graph, JParams(beam=c.beam, max_active=c.max_active,
                                          lattice_beam=c.lattice_beam,
                                          acoustic_scale=c.acoustic_scale),
                  lattice_records=True, silence_pdfs=tp.model.silence_pdfs, frame_step="v3",
                  layout="padded")
    st = tp.init_state()
    jf = jd.init_frontier(B)
    n = torch.full((B,), audio.shape[2], dtype=torch.int32)
    for i in range(N_CHUNKS):
        fs, feats, fv = tp.ex.extract_chunk(st["feat"], torch.from_numpy(audio[i]), n_samples=n)
        am, ll, lv = tp.am.process_chunk(st["am"], feats, fv)
        st = {"feat": fs, "am": am}
        jf, jr, _, _ = jd.decode_chunk(jf, (ll * 1e-3 + torch.from_numpy(lb[i])).numpy(),
                                       lv.numpy())
        for k in jr:
            a, b = trecs[k][i].numpy(), np.asarray(jr[k])
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=k)
    assert int(torch.isfinite(trecs["f_cost"]).sum(-1).max()) > 1
    assert (trecs["lat_arc"][:, :, :, 1:] >= 0).any()  # eps rounds took eps arcs
