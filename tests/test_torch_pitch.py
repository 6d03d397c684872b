"""vosk_tpu_torch/ops/pitch.py and the pitch path through the feature
extractor against vosk_tpu's, on the CPU (end to end:
tests/test_torch_pitch_e2e.py).

Seeded signals (pure tones at the f0s of tests/test_pitch.py, a
voiced/unvoiced transition, an f0 step 220 -> 330 Hz, noise) go through
both packages.  Criteria: the chosen lag equals the source's on every
frame except where the source's two best Viterbi costs lie within 1e-4 (a
tie either may break either way; log pitch after a tie broken the other
way is not compared, since that lag enters the ring mean and the next
delta);
POV, normalized log pitch and delta within atol 1e-4 (the offline POV
feature within 1e-3, for the reason at its test); the carried state within
1e-4 (the frame-energy sum, in squared sample units of order 1e10, within
a relative 1e-5).  MFCC dims within 1e-3, as in
tests/test_torch_features.py.  Within the port, any chunking gives
bit-equal pitch features.
"""
import jax
import numpy as np
import pytest
import torch

from vosk_tpu.ops import features as JF
from vosk_tpu.ops import pitch as JP
from vosk_tpu_torch.ops import features as TF
from vosk_tpu_torch.ops import pitch as TP

RATE = 16000
TIE = 1e-4


def _signal(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    if kind.startswith("tone"):
        f0 = float(kind[4:])
        x = 3000 * np.sin(2 * np.pi * f0 * t) + 30 * rng.standard_normal(n)
    elif kind == "step":  # 220 -> 330 Hz halfway
        ph = np.cumsum(2 * np.pi * np.where(t < t[-1] / 2, 220.0, 330.0) / RATE)
        x = 3000 * np.sin(ph) + 30 * rng.standard_normal(n)
    elif kind == "transition":  # noise, a 180 Hz tone, noise
        third = n // 3
        x = rng.standard_normal(n) * 120
        x[third:2 * third] = (np.sin(2 * np.pi * 180.0 * t[third:2 * third]) * 3000
                              + rng.standard_normal(third) * 30)
    else:
        x = rng.standard_normal(n) * 500
    return x.astype(np.float32)


# ------------------------------------------------------ StreamingPitch.frame_features


def _jax_lags_and_gaps(sp, jst, buf, start0, valid, F):
    """The source's chosen lag and the gap between its two best costs per
    frame: its tracker one frame at a time (the same samples a chunk's
    frame f reads), reading the renormalised forward costs it carries."""
    one = jax.jit(lambda st, b, s, v: sp.frame_features(st, b, s, 1, v))
    lags = np.full(valid.shape, -1)
    gaps = np.full(valid.shape, np.inf)
    for f in range(F):
        jst, _ = one(jst, buf, start0 + f * sp.sh16, valid[:, f:f + 1])
        fwd = np.sort(np.asarray(jst["fwd"]), axis=1)
        for b in np.flatnonzero(valid[:, f]):
            lags[b, f] = int(np.argmin(np.asarray(jst["fwd"])[b]))
            gaps[b, f] = fwd[b, 1] - fwd[b, 0]
    return lags, gaps


def _chunks(kind, B, n_chunks, F, sp):
    """Consecutive chunks of one signal per row: (buf [B, W], start0 [B],
    valid [B, F]) with a per-row window offset and ragged prefix masks."""
    W = 64 + sp.W16 + (F - 1) * sp.sh16 + sp.ws16 + sp.la16
    sig = np.stack([_signal(kind, (n_chunks + 1) * F * sp.sh16 + W, seed=b)
                    for b in range(B)])
    out = []
    for c in range(n_chunks):
        g0 = 4000 + c * F * sp.sh16
        off = sp.W16 + 8 * np.arange(B)
        buf = np.stack([sig[b, g0 - off[b]: g0 - off[b] + W] for b in range(B)])
        lens = np.array([F, F - 3 - c, 0 if c == 1 else F - 1])[:B]
        valid = np.arange(F)[None, :] < lens[:, None]
        out.append((buf, off.astype(np.int32), valid))
    return out


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", ["tone220", "transition", "step", "noise"])
def test_frame_features_match_jax(B, kind):
    """The forward costs do not depend on which lag a frame emits, so lags,
    POV features and forward costs are compared on every frame (a lag may
    differ only at a tie); log pitch enters the ring mean and the next
    delta, so normalized log pitch, delta and the ring only up to a row's
    first tie broken the other way."""
    F = 21
    js, ts = JP.StreamingPitch(), TP.StreamingPitch(device="cpu")
    jfull = jax.jit(lambda st, b, s, v: js.frame_features(st, b, s, F, v))
    jst, tst = js.init_state(B), ts.init_state(B)
    clean = np.ones(B, bool)  # rows with no tie broken the other way so far
    lags_compared = 0
    for buf, start0, valid in _chunks(kind, B, 3, F, js):
        lags, gaps = _jax_lags_and_gaps(js, jst, buf, start0, valid, F)
        jst, jfeat = jfull(jst, buf, start0, valid)
        tst, tfeat, tlags, tgaps = ts.track(tst, torch.from_numpy(buf),
                                            torch.from_numpy(start0), F,
                                            torch.from_numpy(valid), gaps=True)
        jfeat, tfeat, tlags = np.asarray(jfeat), tfeat.numpy(), tlags.numpy()
        np.testing.assert_allclose(tgaps.numpy()[valid], gaps[valid], rtol=0, atol=1e-4)
        for b in range(B):
            for f in np.flatnonzero(valid[b]):
                if tlags[b, f] != lags[b, f]:
                    assert gaps[b, f] < TIE, (b, f)
                    clean[b] = False
                    continue
                lags_compared += 1
                cols = slice(0, 3) if clean[b] else slice(0, 1)
                np.testing.assert_allclose(tfeat[b, f, cols], jfeat[b, f, cols], rtol=0,
                                           atol=1e-4)
            np.testing.assert_array_equal(tfeat[b][~valid[b]], 0.0)
            keys = ("fwd", "ring_logp", "ring_w", "prev_logp") if clean[b] else ("fwd",)
            for k in keys:
                np.testing.assert_allclose(tst[k][b].numpy(), np.asarray(jst[k])[b],
                                           rtol=0, atol=1e-4, err_msg=k)
            for k in ("ring_pos", "n_frames"):
                assert int(tst[k][b]) == int(np.asarray(jst[k])[b]), k
            np.testing.assert_allclose(float(tst["e_sum"][b]), float(np.asarray(jst["e_sum"])[b]),
                                       rtol=1e-5)
    assert lags_compared >= 30 * B


# ------------------------------------------------------ compute_pitch_features


@pytest.mark.parametrize("kind", ["tone60", "tone100", "tone220", "tone330", "transition",
                                  "step", "noise"])
def test_compute_pitch_features_match_jax(kind):
    wav = _signal(kind, RATE, seed=3)
    jf, jhz, jpov = JP.compute_pitch_features(wav)
    tf, thz, tpov = TP.compute_pitch_features(wav, device="cpu")
    assert tf.shape == jf.shape and tf.dtype == np.float32
    # the offline path is one backtrack: a tie anywhere may move the path
    # on both sides of it, so a signal with one would be compared up to it
    np.testing.assert_array_equal(thz, jhz)
    np.testing.assert_allclose(tpov, jpov, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tf[:, 1:], jf[:, 1:], rtol=0, atol=1e-4)
    # the POV feature 2((1.0001 - c)^0.15 - 1) has slope ~100 at c = 0.999:
    # there the NCCF's summation-order difference (~1e-6) becomes ~1e-4
    np.testing.assert_allclose(tf[:, 0], jf[:, 0], rtol=0, atol=1e-3)


# ------------------------------------------------------ the feature extractor


def _extractors():
    def opts(F):
        return F.MfccOptions(frame_opts=F.FrameOptions(dither=0.0),
                             mel_opts=F.MelOptions(num_bins=23), num_ceps=13)

    return (JF.FeatureExtractor(opts(JF), pitch_opts={}),
            TF.FeatureExtractor(opts(TF), pitch_opts={}, device="cpu"))


def _close(t, j, base=13):
    np.testing.assert_allclose(t[..., :base], j[..., :base], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t[..., base:], j[..., base:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("S", [800, 1600, 3200])
def test_extract_chunk_matches_jax(S):
    jx, tx = _extractors()
    assert (tx.dim, tx.base_dim, tx.flush_pad_samples) == (jx.dim, jx.base_dim,
                                                            jx.flush_pad_samples)
    B, n = 2, 3 * 3200
    audio = np.stack([_signal("step", n, 1), _signal("transition", n, 2)])
    js, ts = jx.init_stream_state(B, S), tx.init_stream_state(B, S)
    assert ts["tail"].shape == js["tail"].shape
    for c in range(n // S):
        chunk = audio[:, c * S:(c + 1) * S]
        ns = np.array([S, S if c < n // S - 1 else S // 3], np.int32)
        js, jf, jv = jx.extract_chunk(js, chunk, None, ns)
        ts, tf, tv = tx.extract_chunk(ts, torch.from_numpy(chunk), torch.from_numpy(ns))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        _close(tf.numpy(), np.asarray(jf))
        for k in ("tail", "tail_len", "total_samples", "frames_emitted"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
        for k in ("fwd", "ring_logp", "ring_w", "prev_logp"):
            np.testing.assert_allclose(ts["pitch"][k].numpy(), np.asarray(js["pitch"][k]),
                                       rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(ts["pitch"]["e_sum"].numpy(),
                                   np.asarray(js["pitch"]["e_sum"]), rtol=1e-5)


def test_chunking_gives_bit_equal_pitch():
    """The source's chunk-invariance test (tests/test_pitch.py) on the port:
    any chunking gives the offline extract's pitch dims bit for bit."""
    _, tx = _extractors()
    wav = _signal("tone240", 8000, 0)
    off = tx.extract(wav[None])[0].numpy()
    for S in (800, 1600, 3200):
        st = tx.init_stream_state(1, S)
        wavp = np.concatenate([wav, np.zeros(tx.flush_pad_samples, np.float32)])
        outs = []
        for pos in range(0, len(wavp), S):
            c = wavp[pos:pos + S]
            n = len(c)
            st, f, v = tx.extract_chunk(st, torch.from_numpy(np.pad(c, (0, S - n))[None]),
                                        torch.tensor([n], dtype=torch.int32))
            outs.append(f[0, :int(v[0].sum())].numpy())
        stream = np.concatenate(outs)[:len(off)]
        np.testing.assert_array_equal(off[:, 13:], stream[:, 13:], err_msg=f"S={S}")
        np.testing.assert_allclose(off[:, :13], stream[:, :13], atol=1e-3)


@pytest.mark.parametrize("kind", ["tone220", "step", "noise"])
def test_extract_matches_jax(kind):
    jx, tx = _extractors()
    wav = _signal(kind, 9000, 4)
    j, t = np.asarray(jx.extract(wav[None])), tx.extract(wav[None]).numpy()
    assert t.shape == j.shape
    _close(t, j)
    assert tx.extract(wav[:100]).shape == (0, 16)


def test_pitchcheck_holds_a_stream_to_itself():
    """The card-vs-CPU helper of chip_smoke.py and tests/test_torch_cuda.py
    on two CPU extractors at different chunkings (bit-equal pitch)."""
    from vosk_tpu_torch.utils import pitchcheck

    _, a = _extractors()
    _, b = _extractors()
    audio = np.stack([_signal("step", 4800, 5), _signal("noise", 4800, 6)])
    got, want = pitchcheck.stream(a, audio, 1600), pitchcheck.stream(b, audio, 3200)
    stats = pitchcheck.compare(got, want)
    assert stats["frames"] == 2 * 28 and stats["ties_broken_otherwise"] == 0
    assert stats["pov_err"] == stats["pitch_err"] == 0.0 and stats["pitch_frames"] == 56
    assert "frame_features" not in vars(a.pitch)
    bad = [(f.copy(), l + 1, g) for f, l, g in got]
    with pytest.raises(AssertionError):
        pitchcheck.compare(bad, want)
