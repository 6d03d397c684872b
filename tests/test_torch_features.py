"""vosk_tpu_torch/ops/features.py against vosk_tpu/ops/features.py.

Streaming chunks of seeded noise audio through both extractors, with a
shorter last chunk on one channel (prefix mask).  Tolerance: atol=1e-3 on
the features.  The reference itself drifts by about 1e-5 between its
streaming and offline formulations, and `log` on near-empty mel bands
amplifies that; frame counts, masks and the sample ring must match
exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vosk_tpu.ops import features as JF
from vosk_tpu_torch.ops import features as TF


def _pair(kind):
    def opts(F):
        fo = F.FrameOptions(dither=0.0)
        if kind == "mfcc_energy":
            return F.MfccOptions(frame_opts=fo, mel_opts=F.MelOptions(num_bins=23))
        if kind == "mfcc_bench":  # the bench model's features (benchdata.py)
            return F.MfccOptions(
                frame_opts=fo,
                mel_opts=F.MelOptions(num_bins=40, low_freq=20.0, high_freq=-400.0),
                num_ceps=40, use_energy=False)
        return F.FbankOptions(frame_opts=fo)

    return JF.FeatureExtractor(opts(JF)), TF.FeatureExtractor(opts(TF), device="cpu")


@pytest.mark.parametrize("kind", ["mfcc_energy", "mfcc_bench", "fbank"])
def test_streaming_chunks_match(kind):
    jx, tx = _pair(kind)
    B, S, n_chunks = 2, 3200, 4
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((B, S * n_chunks)) * 500).astype(np.float32)
    js = jx.init_stream_state(B, S)
    ts = tx.init_stream_state(B, S)
    for c in range(n_chunks):
        chunk = audio[:, c * S:(c + 1) * S]
        ns = np.array([S, S if c < n_chunks - 1 else 1234], np.int32)
        js, jf, jv = jx.extract_chunk(js, chunk, n_samples=ns)
        ts, tf, tv = tx.extract_chunk(ts, torch.from_numpy(chunk),
                                      n_samples=torch.from_numpy(ns))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-3, rtol=0)
        for k in ("tail_len", "total_samples", "frames_emitted"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
        np.testing.assert_array_equal(ts["tail"].numpy(), np.asarray(js["tail"]))


def test_pitch_model_raises():
    """A model with pitch options builds the source's extractor (3 pitch
    dims after the base ones, the same lookahead; it raised before the
    pitch slice); pitch options the tracker cannot take raise, as in the
    source.  Pitch parity: tests/test_torch_pitch.py."""
    from vosk_tpu.io import native as j_native
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.utils import benchdata

    m = benchdata.make_bench_model(num_states=500, num_pdfs=20, hidden=16,
                                   max_active=100, num_words=10, device="cpu", feat_dim=43)
    for opts in ({}, {"min_f0": 70.0, "max_f0": 350.0}):
        m.config.pitch_opts = opts
        t = native.NativeModel(m.config, m.am_params, m.graph, m.words, m.phones,
                               m.phone_of_pdf, m.silence_pdfs, device="cpu").feature_extractor()
        j = j_native.NativeModel(m.config, m.am_params, m.graph, m.words, m.phones, None,
                                 m.phone_of_pdf, m.silence_pdfs,
                                 j_native.Topology()).feature_extractor()
        assert (t.dim, t.base_dim, t.flush_pad_samples) == (j.dim, j.base_dim,
                                                            j.flush_pad_samples)
        assert t.dim == 43 == m.am_config.feat_dim
        assert dataclasses.asdict(t.pitch.opts) == dataclasses.asdict(j.pitch.opts)
    m.config.pitch_opts = {"resample_rate": 3000.0}
    with pytest.raises(ValueError):
        native.NativeModel(m.config, m.am_params, m.graph, m.words, m.phones,
                           m.phone_of_pdf, m.silence_pdfs, device="cpu").feature_extractor()


def test_inverse_mel_scale_and_num_frames_ready_match_jax():
    """inverse_mel_scale inverts mel_scale as the source's does, to f64
    rounding; num_frames_ready gives the source's counts for Python ints
    and for an int32 tensor of counts (exact: integer arithmetic)."""
    mel = np.linspace(0.0, 4000.0, 97)
    np.testing.assert_array_equal(TF.inverse_mel_scale(mel), JF.inverse_mel_scale(mel))
    freq = np.linspace(0.0, 8000.0, 33)
    np.testing.assert_allclose(TF.inverse_mel_scale(TF.mel_scale(freq)), freq, rtol=1e-12,
                               atol=1e-9)
    for fo_kw in ({}, {"frame_length_ms": 20.0, "frame_shift_ms": 5.0}):
        jfo, tfo = JF.FrameOptions(**fo_kw), TF.FrameOptions(**fo_kw)
        counts = [0, 1, 399, 400, 401, 559, 560, 561, 3200, 16000, 16001]
        for n in counts:
            assert TF.num_frames_ready(n, tfo) == JF.num_frames_ready(n, jfo)
        got = TF.num_frames_ready(torch.tensor(counts, dtype=torch.int32), tfo)
        want = JF.num_frames_ready(np.array(counts, np.int32), jfo)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
