"""The port's OnlineIvectorExtractor against vosk_tpu.ops.ivector, on the CPU.

A seeded extractor (6-dim features, splice +-2, LDA to 5, 8 Gaussians,
i-vector dim 4, 3 selected per frame) is driven update -> reweight ->
update ... -> flush -> current at B = 2 with ragged chunks.  Selected
Gaussian indices and frame counters must be equal; the statistics and the
i-vector agree within rtol 1e-4, atol 1e-4 (measured on this input: about
5e-6 on xstat, 6e-7 on gamma, 2e-6 on the i-vector).

The source's `reweight` broadcasts its ring position against [B, N] frame
ids and so takes one channel at a time; the JAX side is reweighted per
channel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosk_tpu.io.kaldi_ivector import DiagGmm, IvectorDirConfig, IvectorExtractor
from vosk_tpu.ops.ivector import OnlineIvectorExtractor as JExtractor
from vosk_tpu_torch.io import kaldi_ivector
from vosk_tpu_torch.ops.ivector import OnlineIvectorExtractor

RTOL = ATOL = 1e-4
DIN, D, G, I, SPLICE, F = 6, 5, 8, 4, 2, 10
EXACT = ("centers_done", "feats_seen", "hist_len", "ring_idx", "ring_pos", "hist")


def _config(seed=0, mod=None):
    """A seeded extractor config, built with the JAX package's classes (or
    the port's copies, `mod`)."""
    Gmm, Ie, Cfg = (DiagGmm, IvectorExtractor, IvectorDirConfig) if mod is None else (
        mod.DiagGmm, mod.IvectorExtractor, mod.IvectorDirConfig)
    rng = np.random.default_rng(seed)
    gmm = Gmm(np.zeros(G, np.float32), np.full(G, 1 / G, np.float32),
              rng.standard_normal((G, D)).astype(np.float32),
              rng.uniform(0.5, 2.0, (G, D)).astype(np.float32))
    gmm.gconsts = gmm.compute_gconsts()
    A = rng.standard_normal((G, D, D)).astype(np.float32) * 0.2
    sig = (np.einsum("gij,gkj->gik", A, A) + np.eye(D, dtype=np.float32)).astype(np.float32)
    ie = Ie(M=(rng.standard_normal((G, D, I)) * 0.3).astype(np.float32), sigma_inv=sig,
            prior_offset=2.0, w_vec=np.full(G, 1 / G, np.float32))
    lda = (rng.standard_normal((D, DIN * (2 * SPLICE + 1) + 1)) * 0.3).astype(np.float32)
    cmvn = np.zeros((2, DIN + 1))
    cmvn[0, :-1] = rng.standard_normal(DIN) * 5
    cmvn[0, -1] = 5
    return Cfg(dubm=gmm, extractor=ie, lda=lda, global_cmvn=cmvn, splice_left=SPLICE,
               splice_right=SPLICE, num_gselect=3, min_post=0.025)


def _assert_state(t, j):
    for k in j:
        got, want = t[k].numpy(), np.asarray(j[k])
        if k in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=k)


def _j_reweight(jx, js, ids, ws):
    parts = [jx.reweight({k: v[b: b + 1] for k, v in js.items()}, ids[b: b + 1],
                         ws[b: b + 1]) for b in range(ids.shape[0])]
    return {k: jnp.concatenate([p[k] for p in parts]) for k in js}


@pytest.fixture(scope="module")
def extractors():
    cfg = _config()
    return JExtractor(cfg, chunk_frames=F, ring=16), OnlineIvectorExtractor(
        cfg, chunk_frames=F, ring=16, device="cpu")


def test_update_reweight_flush_current_match_jax(extractors):
    jx, tx = extractors
    B = 2
    rng = np.random.default_rng(1)
    js, ts = jx.init_state(B), tx.init_state(B)
    weighted = 0
    for i in range(5):
        feats = (rng.standard_normal((B, F, DIN)) * 3).astype(np.float32)
        valid = np.ones((B, F), bool)
        valid[1, F - 2 - i:] = False
        js = jx.update(js, feats, valid)
        ts = tx.update(ts, torch.from_numpy(feats), torch.from_numpy(valid))
        _assert_state(ts, js)
        # silence-weight every other new frame of channel 0 and the newest
        # of channel 1, padded with -1; frames that land in ring slot 0
        # (frame % 16 == 0) are left out, where the source's padding undoes
        # the slot's update (see the test below)
        done = ts["centers_done"].numpy()
        ids = np.full((B, 4), -1, np.int32)
        ch0 = [f for f in range(weighted, done[0], 2) if f % 16][:4]
        ids[0, : len(ch0)] = ch0
        ids[1, 0] = done[1] - 1 if (done[1] - 1) % 16 else done[1] - 2
        weighted = done[0]
        ws = np.where(ids >= 0, 0.001, 1.0).astype(np.float32)
        js = _j_reweight(jx, js, ids, ws)
        ts = tx.reweight(ts, ids, ws)
        _assert_state(ts, js)
    js, ts = jx.flush(js), tx.flush(ts)
    _assert_state(ts, js)
    want, got = np.asarray(jx.current(js)), tx.current(ts).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0.1
    assert (ts["ring_w"] < 1).any()  # reweighting reached the ring


def test_padded_reweight_writes_each_slot_once(extractors):
    """A silence frame in ring slot 0 followed by -1 padding: the port gives
    what both packages give without the padding (the source's padding
    writes slot 0 back after the update; ROADMAP C)."""
    jx, tx = extractors
    feats = (np.random.default_rng(2).standard_normal((1, F, DIN)) * 3).astype(np.float32)
    js = jx.update(jx.init_state(1), feats)
    ids, ws = np.array([[0, 1]], np.int32), np.array([[0.001, 0.001]], np.float32)
    pad_ids = np.array([[0, 1, -1, -1]], np.int32)
    pad_ws = np.array([[0.001, 0.001, 1.0, 1.0]], np.float32)
    want = jx.reweight(js, ids, ws)
    for i, w in ((ids, ws), (pad_ids, pad_ws)):
        ts = tx.update(tx.init_state(1), torch.from_numpy(feats))
        _assert_state(tx.reweight(ts, i, w), want)
    assert float(np.asarray(want["ring_w"])[0, 0]) == pytest.approx(0.001)


def test_ivector_dir_roundtrip_both_ways(tmp_path):
    """The port's ivector/ reader and writer against the source's."""
    from vosk_tpu.io.kaldi_ivector import read_ivector_dir as j_read
    from vosk_tpu.io.kaldi_ivector import write_ivector_dir as j_write

    j_write(tmp_path / "j", _config(3))
    kaldi_ivector.write_ivector_dir(tmp_path / "t", _config(3, kaldi_ivector))
    for name in ("final.dubm", "final.ie", "final.mat", "global_cmvn.stats",
                 "splice.conf", "ivector_extractor.conf"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    got, want = kaldi_ivector.read_ivector_dir(tmp_path / "j"), j_read(tmp_path / "t")
    for a, b in ((got.dubm, want.dubm), (got.extractor, want.extractor)):
        for f in ("gconsts", "weights", "means_invvars", "inv_vars", "M", "sigma_inv", "w_vec"):
            if hasattr(b, f):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(got.lda, want.lda)
    np.testing.assert_array_equal(got.global_cmvn, want.global_cmvn)
    assert (got.splice_left, got.num_gselect, got.min_post, got.max_count) == (
        want.splice_left, want.num_gselect, want.min_post, want.max_count)
