"""The toy pitch model through vosk_tpu_torch and vosk_tpu, on the CPU.

`toydata.build_toy_model(dir, train_steps=400, pitch=True)` (as
tests/test_e2e.py::test_pitch_model_e2e) gives identical JSON through
both packages' `Model` + `KaldiRecognizer` and `BatchModel` (the source's
batch channel reset mended in the test; ROADMAP C), and a Kaldi export of
it with an `ivector/` over the base features decodes in the port where the
source fails (ROADMAP C).
"""
import json

import jax
import numpy as np
import pytest

import vosk_tpu
import vosk_tpu_torch
from vosk_tpu.utils import toydata
from vosk_tpu_torch.runtime import native_lattice


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


@pytest.fixture(scope="module")
def pitch_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("toy_pitch") / "model")
    toydata.build_toy_model(path, train_steps=400, pitch=True)
    return path


def _pcm(words, seed):
    wav = toydata.make_test_wav(words, seed=seed)
    return np.clip(wav, -32768, 32767).astype("<i2").tobytes()


def _stream(mod, model, pcm, step=6400):
    rec = mod.KaldiRecognizer(model, 16000)
    rec.SetWords(True)
    out = []
    for i in range(0, len(pcm), step):
        rec.AcceptWaveform(pcm[i:i + step])
        out.append(rec.PartialResult())
    out.append(rec.FinalResult())
    return out, rec


@pytest.mark.parametrize("words", [["one", "six", "two"], ["seven", "zero", "four", "three"]])
def test_toy_pitch_model_streams_as_jax(pitch_dir, words):
    jm, tm = vosk_tpu.Model(pitch_dir), vosk_tpu_torch.Model(pitch_dir, device="cpu")
    assert tm._model.config.pitch_opts == jm._model.config.pitch_opts == {}
    want, _ = _stream(vosk_tpu, jm, _pcm(words, 321))
    got, rec = _stream(vosk_tpu_torch, tm, _pcm(words, 321))
    assert got == want
    assert json.loads(got[-1])["text"] == " ".join(words)
    assert rec._rec.ex.dim == 23 and rec._rec._feat_state["pitch"]["n_frames"][0] > 0


def _batch(mod, model_dir, datas, **kw):
    bm = mod.BatchModel(model_dir, max_batch_size=2, **kw)
    recs = [mod.BatchRecognizer(bm, 16000) for _ in datas]
    for r, d in zip(recs, datas):
        r.AcceptWaveform(d)
    for r in recs:
        r.FinishStream()
    bm.Wait()
    return [r.Result() for r in recs]


def test_toy_pitch_model_batch_as_jax(pitch_dir, monkeypatch):
    """The source's BatchPipeline cannot open a stream on a pitch model: its
    channel reset indexes the nested pitch state as an array (ROADMAP C).
    With that reset mended here, row by row, its results are the port's.
    Neither batch path flushes the pitch lookahead at FinishStream; on this
    audio that leaves the text and times as the streaming recognizer's."""
    from vosk_tpu.runtime import batch as j_batch

    datas = [_pcm(["six", "four"], 210), _pcm(["two", "seven", "zero"], 211)]
    with pytest.raises(AttributeError):
        _batch(vosk_tpu, pitch_dir, datas[:1])

    def reset_channel(self, ch):
        fresh = (self.ex.init_stream_state(1, self.chunk_samples),
                 self.am.init_stream_state(1, self.max_feat_frames),
                 self.dec.init_frontier(1))
        self._feat_state, self._am_state, self._frontier = (
            jax.tree_util.tree_map(lambda a, b: a.at[ch].set(b[0]), s, f)
            for s, f in zip((self._feat_state, self._am_state, self._frontier), fresh))
        self._records[ch] = []

    monkeypatch.setattr(j_batch.BatchPipeline, "_reset_channel", reset_channel)
    want = _batch(vosk_tpu, pitch_dir, datas)
    got = _batch(vosk_tpu_torch, pitch_dir, datas, device="cpu")
    assert got == want
    streamed = [json.loads(_stream(vosk_tpu_torch, vosk_tpu_torch.Model(pitch_dir, device="cpu"),
                                   d)[0][-1]) for d in datas]
    assert [json.loads(g) for g in got] == streamed


def test_pitch_with_ivectors_feeds_base_features(pitch_dir, tmp_path):
    """A Kaldi dir with pitch.conf beside a base-feature ivector/ (Kaldi's
    OnlineNnet2FeaturePipeline feeds the extractor the MFCCs without the
    pitch dims): the source feeds it every dim and fails at the first
    chunk (ROADMAP C); the port feeds it the base dims and decodes."""
    from vosk_tpu_torch.io import native
    from vosk_tpu_torch.io.kaldi_export import export_kaldi_dir
    from vosk_tpu_torch.utils import kaldidata

    m = native.load_model(pitch_dir, device="cpu")
    plain, ivdir = tmp_path / "plain", tmp_path / "ivector"
    export_kaldi_dir(m, plain)
    base = m.am_config.feat_dim - 3
    kaldidata.write_ivector_kaldi_dir(
        m, plain, ivdir, kaldidata.make_ivector_config(base, num_gauss=4, ubm_dim=5,
                                                       ivector_dim=6, splice=2), seed=3)
    kaldidata.write_pitch_conf(ivdir)
    pcm = _pcm(["three", "seven", "one"], 300)
    jrec = vosk_tpu.KaldiRecognizer(vosk_tpu.Model(str(ivdir)), 16000)
    with pytest.raises(Exception, match="Failed to process waveform"):
        jrec.AcceptWaveform(pcm)
    out, rec = _stream(vosk_tpu_torch, vosk_tpu_torch.Model(str(ivdir), device="cpu"), pcm)
    r = rec._rec
    assert r.ex.dim == base + 3 and r.iv.cfg.lda.shape[1] == base * 5 + 1
    assert int(r._iv_state["centers_done"][0]) > 0 and json.loads(out[-1])["text"]
    iv = r.iv.current(r._iv_state)[0].numpy()
    assert np.all(np.isfinite(iv)) and np.any(iv != 0)
