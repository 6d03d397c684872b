"""The v3 step end to end: vosk_tpu_torch against vosk_tpu on a model whose
graph keeps labeled epsilon arcs, on the CPU.

The toy model (tests/test_torch_streaming.py) is copied with half of its
graph's epsilon arcs given word labels.  `prepare_graph_v4` keeps labeled
eps arcs, so both packages' shared decoders pick the v3 step under "auto".
A stream long enough to fold its record window through `Model` +
`KaldiRecognizer`, and interleaved streams through `BatchModel`, must give
the source's JSON (text, words and times identical; confidences within
1e-3, as the AMs differ at float rounding).
"""
import shutil

import numpy as np
import pytest

import test_torch_e2e as batch_e2e
import test_torch_streaming as streaming
import vosk_tpu
import vosk_tpu_torch
from vosk_tpu.utils import toydata
from vosk_tpu_torch.runtime import native_lattice


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


@pytest.fixture(scope="module")
def eps_dir(tmp_path_factory):
    """The toy model with a seeded half of its eps arcs labeled with words."""
    root = tmp_path_factory.mktemp("toy_eps")
    toydata.build_toy_model(str(root / "toy"), train_steps=400)
    path = root / "model"
    shutil.copytree(root / "toy", path)
    z = dict(np.load(path / "graph.npz"))
    rng = np.random.default_rng(0)
    ol = z["eps_olabel"].copy()
    hit = rng.random(len(ol)) < 0.5
    ol[hit] = rng.integers(1, len(toydata.WORDS) + 1, int(hit.sum()))
    z["eps_olabel"] = ol.astype(np.int32)
    np.savez(path / "graph.npz", **z)
    return str(path)


@pytest.fixture(scope="module")
def models(eps_dir):
    return vosk_tpu.Model(eps_dir), vosk_tpu_torch.Model(eps_dir, device="cpu")


def test_auto_picks_v3_on_labeled_eps(models):
    jm, tm = models
    jd, td = jm._model.shared_decoder(), tm._model.shared_decoder()
    assert jd.frame_step == td.frame_step == "v3"
    assert td.eps_iters == jd.eps_iters > 0 and (td.graph.eps_olabel != 0).any()
    rec = vosk_tpu_torch.KaldiRecognizer(tm, 16000)
    assert rec._rec.dec is td


@pytest.mark.parametrize("alternatives", [0, 3])
def test_folding_stream_matches_jax(models, alternatives):
    """A long utterance with a 40-frame window folds several times; every
    partial and final result is the source's."""
    words = ["five", "six", "seven", "zero", "one", "two"] * 2
    wav, _ = toydata.synth_utterance(words, np.random.default_rng(7), sil_between=False)

    def setup(r):
        r._rec.max_window_frames = 40
        r._rec.keep_window_frames = 24
        r.SetWords(True)
        r.SetMaxAlternatives(alternatives)

    got, rec = streaming._both(models, streaming._split(streaming._pcm(wav), 6400),
                               setup=setup, partial=True)
    assert rec._rec._folded_frames > 0, "folding never engaged"
    assert rec._rec._records[-1]["prev"].shape[2] == 1 + rec._rec.dec.eps_iters
    assert isinstance(got[-1], str) and got[-1].startswith("{")


def test_endpointed_stream_matches_jax(models):
    """Two utterances split by an endpoint: Result() at the endpoint, then
    FinalResult()."""
    rng = np.random.default_rng(0)
    silence = (60.0 * rng.standard_normal(16000 * 3)).astype(np.float32)
    audio = np.concatenate([toydata.make_test_wav(["two", "one"], seed=11), silence,
                            toydata.make_test_wav(["seven"], seed=12)])
    got, _ = streaming._both(models, streaming._split(streaming._pcm(audio), 3200),
                             setup=lambda r: r.SetWords(True))
    assert sum(isinstance(x, str) for x in got) >= 2


def test_batch_streams_match_jax(eps_dir):
    texts = [["one", "two"], ["seven"], ["zero", "five", "six"]]
    datas = [batch_e2e._pcm(toydata.make_test_wav(t, seed=20 + i)) for i, t in enumerate(texts)]
    rng = np.random.default_rng(1)
    silence = (60.0 * rng.standard_normal(16000 * 3)).astype(np.float32)
    datas.append(batch_e2e._pcm(np.concatenate(
        [toydata.make_test_wav(["four"], seed=30), silence,
         toydata.make_test_wav(["three"], seed=31)])))
    want = batch_e2e._run(vosk_tpu, eps_dir, datas, 8000)
    got = batch_e2e._run(vosk_tpu_torch, eps_dir, datas, 8000, device="cpu")
    batch_e2e._assert_same(got, want)
    assert all(r and all("text" in x for x in r) for r in got)

