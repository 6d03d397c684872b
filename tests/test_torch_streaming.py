"""vosk_tpu_torch.KaldiRecognizer against vosk_tpu's, on the CPU.

The toy model (v4/packed16 decoder, f32 AM), built once per module into
pytest's temp dir, serves both packages.  Each case feeds both recognizers
the same PCM in the same pieces (tests/test_e2e.py is the template) and
compares every returned result: identical text, words, starts and ends;
word confidences and alternatives' confidences (their negated path costs)
within 1e-3, since the AMs differ at float rounding.  A subprocess shows
that a KaldiRecognizer decode runs with jax and vosk_tpu blocked.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vosk_tpu
import vosk_tpu_torch
from vosk_tpu.ops.resample import resample_offline
from vosk_tpu.utils import toydata
from vosk_tpu_torch.runtime import native_lattice

REPO = Path(__file__).resolve().parents[1]
_NUM = re.compile(r'confidence="([^"]+)"')


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("toy") / "model")
    toydata.build_toy_model(path, train_steps=400)
    return path


@pytest.fixture(scope="module")
def models(toy_dir):
    return vosk_tpu.Model(toy_dir), vosk_tpu_torch.Model(toy_dir, device="cpu")


def _wav(words, seed, sil=True):
    return toydata.make_test_wav(words, seed=seed, sil_between=sil)


def _pcm(audio):
    return np.clip(audio, -32768, 32767).astype("<i2").tobytes()


def _drive(mod, model, pieces, rate=16000, grammar=None, setup=None,
           partial=False):
    """Feed `pieces` one AcceptWaveform each; collect the endpoint flags,
    Result() after each endpoint, PartialResult() after each other piece
    (when `partial`), and FinalResult()."""
    args = (model, rate) if grammar is None else (model, rate, grammar)
    rec = mod.KaldiRecognizer(*args)
    if setup is not None:
        setup(rec)
    out = []
    for piece in pieces:
        hit = rec.AcceptWaveform(piece)
        out.append(hit)
        if hit:
            out.append(rec.Result())
        elif partial:
            out.append(rec.PartialResult())
    out.append(rec.FinalResult())
    return out, rec


def _same_conf(g, w):
    return abs(g - w) <= 1e-3


def _assert_same_json(g, w, path="$"):
    if isinstance(w, dict):
        assert isinstance(g, dict) and g.keys() == w.keys(), path
        for k in w:
            if k in ("conf", "confidence"):
                assert _same_conf(g[k], w[k]), (path, k, g[k], w[k])
            else:
                _assert_same_json(g[k], w[k], f"{path}.{k}")
    elif isinstance(w, list):
        assert isinstance(g, list) and len(g) == len(w), path
        for i, (x, y) in enumerate(zip(g, w)):
            _assert_same_json(x, y, f"{path}[{i}]")
    else:
        assert g == w, (path, g, w)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str) and w.startswith("<?xml"):  # NLSML
            assert _NUM.sub("", g) == _NUM.sub("", w)
            for x, y in zip(_NUM.findall(g), _NUM.findall(w)):
                assert _same_conf(float(x), float(y)), (x, y)
        elif isinstance(w, str):
            _assert_same_json(json.loads(g), json.loads(w))
        else:
            assert g == w


def _both(models, pieces, **kw):
    jm, tm = models
    want, _ = _drive(vosk_tpu, jm, pieces, **kw)
    got, rec = _drive(vosk_tpu_torch, tm, pieces, **kw)
    _assert_same(got, want)
    return got, rec


def _split(data, step):
    return [data[i: i + step] for i in range(0, len(data), step)]


def test_simple_stream_matches_jax(models):
    words = ["one", "five", "zero", "three"]
    got, _ = _both(models, _split(_pcm(_wav(words, 123)), 4000), partial=True)
    assert json.loads(got[-1])["text"] == " ".join(words)


def test_words_match_jax(models):
    got, _ = _both(models, [_pcm(_wav(["seven", "two"], 5))],
                   setup=lambda r: r.SetWords(True))
    res = json.loads(got[-1])
    assert [w["word"] for w in res["result"]] == ["seven", "two"]


@pytest.mark.parametrize("partial_words", [False, True])
def test_partial_results_match_jax(models, partial_words):
    got, _ = _both(models, _split(_pcm(_wav(["four", "six", "two"], 7)), 3200),
                   partial=True,
                   setup=lambda r: r.SetPartialWords(partial_words))
    partials = [json.loads(x) for x in got if isinstance(x, str)][:-1]
    assert partials and all("partial" in p for p in partials)
    assert any(p["partial"] for p in partials)
    assert any("partial_result" in p for p in partials) == partial_words


def test_max_alternatives_match_jax(models):
    def setup(r):
        r.SetMaxAlternatives(3)
        r.SetWords(True)

    got, _ = _both(models, _split(_pcm(_wav(["five", "zero"], 13)), 6400),
                   setup=setup)
    alts = json.loads(got[-1])["alternatives"]
    assert alts[0]["text"] == "five zero"


def test_nlsml_matches_jax(models):
    def setup(r):
        r.SetMaxAlternatives(2)
        r.SetNLSML(True)

    got, _ = _both(models, [_pcm(_wav(["three"], 14))], setup=setup)
    assert got[-1].startswith("<?xml") and "<instance>three</instance>" in got[-1]


def test_endpointed_utterances_match_jax(models):
    """Two utterances split by an endpoint: Result() at the endpoint, then
    FinalResult(); the second's times continue on the stream's time axis."""
    rng = np.random.default_rng(0)
    silence = (60.0 * rng.standard_normal(16000 * 3)).astype(np.float32)
    audio = np.concatenate([_wav(["two", "one"], 11), silence, _wav(["seven"], 12)])
    got, _ = _both(models, _split(_pcm(audio), 3200),
                   setup=lambda r: r.SetWords(True))
    first, *_, last = [json.loads(x) for x in got if isinstance(x, str)]
    assert first["text"] == "two one" and last["text"] == "seven"
    assert last["result"][0]["start"] > first["result"][-1]["end"] + 2.0


@pytest.mark.parametrize("phrases, said", [
    (["one two", "three four"], ["one", "two"]),
    (["one nosuchword two"], ["one", "two"]),  # out-of-vocabulary word skipped
])
def test_grammar_matches_jax(models, phrases, said):
    got, _ = _both(models, [_pcm(_wav(said, 15))], grammar=json.dumps(phrases),
                   setup=lambda r: r.SetWords(True))
    assert json.loads(got[-1])["text"] == " ".join(said)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_numpy_input_matches_jax(models, dtype):
    got, _ = _both(models, [_wav(["zero", "six"], 33).astype(dtype)])
    assert json.loads(got[-1])["text"] == "zero six"


def test_empty_input_matches_jax(models):
    got, _ = _both(models, [b""])
    assert got[0] == 0 and json.loads(got[-1])["text"] == ""


def test_reset_mid_stream_matches_jax(models):
    def drive(mod, model):
        rec = mod.KaldiRecognizer(model, 16000)
        rec.AcceptWaveform(_pcm(_wav(["one"], 9)))
        rec.Reset()
        rec.AcceptWaveform(_pcm(_wav(["six"], 10)))
        return [rec.FinalResult()]

    want, got = drive(vosk_tpu, models[0]), drive(vosk_tpu_torch, models[1])
    _assert_same(got, want)
    assert json.loads(got[0])["text"].endswith("six")


def test_8000hz_input_matches_jax(models):
    audio = resample_offline(_wav(["two", "seven"], 32), 16000, 8000)
    got, _ = _both(models, _split(_pcm(audio), 1600), rate=8000,
                   setup=lambda r: r.SetWords(True))
    assert json.loads(got[-1])["text"] == "two seven"


def test_find_word_matches_jax(models):
    jm, tm = models
    for w in ("one", "seven", "notaword", ""):
        assert tm.FindWord(w) == jm.FindWord(w) == tm.vosk_model_find_word(w)
    assert tm.FindWord("one") > 0 and tm.FindWord("notaword") == -1


@pytest.mark.parametrize("alternatives", [0, 3])
def test_fold_matches_jax(models, alternatives):
    """A long utterance with a 40-frame window (tests/test_streaming_memory.py
    settings) folds several times; words, times and alternatives stay the
    source's."""
    words = ["five", "six", "seven", "zero", "one", "two"] * 2
    wav, _ = toydata.synth_utterance(words, np.random.default_rng(7), sil_between=False)

    def setup(r):
        r._rec.max_window_frames = 40
        r._rec.keep_window_frames = 24
        r.SetWords(True)
        r.SetMaxAlternatives(alternatives)

    got, rec = _both(models, _split(_pcm(wav), 6400), setup=setup, partial=True)
    assert rec._rec._folded_frames > 0, "folding never engaged"
    res = json.loads(got[-1])
    text = res["alternatives"][0]["text"] if alternatives else res["text"]
    assert text == " ".join(words)


def test_spk_model_raises(models, tmp_path):
    """A third argument that is neither a SpkModel nor a grammar raises, as
    in the source; a SpkModel gives the source's spk result (it raised
    before the speaker slice; parity in tests/test_torch_speaker.py)."""
    from vosk_tpu.models.xvector import SpkModel, XvectorConfig, init_xvector_params

    with pytest.raises(TypeError):
        vosk_tpu_torch.KaldiRecognizer(models[1], 16000, object())
    cfg = XvectorConfig(feat_dim=20, hidden_dim=16, embed_dim=8, num_layers=2)
    SpkModel(cfg, init_xvector_params(cfg, seed=1), np.zeros(8, np.float32),
             np.eye(8, dtype=np.float32)).save(tmp_path / "spk")
    pcm = _pcm(_wav(["one", "two", "three", "four"], 60))
    res = []
    for mod, m, kw in ((vosk_tpu, models[0], {}), (vosk_tpu_torch, models[1], {"device": "cpu"})):
        rec = mod.KaldiRecognizer(m, 16000, mod.SpkModel(str(tmp_path / "spk"), **kw))
        rec.AcceptWaveform(pcm)
        res.append(json.loads(rec.FinalResult()))
    want, got = res
    assert got["text"] == want["text"] and got["spk_frames"] == want["spk_frames"] >= 50
    np.testing.assert_allclose(got["spk"], want["spk"], rtol=0, atol=1e-4)


def test_kaldi_recognizer_decodes_without_jax(toy_dir):
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.modules["vosk_tpu"] = None
import numpy as np
import vosk_tpu_torch
model = vosk_tpu_torch.Model({toy_dir!r}, device="cpu")
rec = vosk_tpu_torch.KaldiRecognizer(model, 16000)
rec.SetWords(True)
pcm = (np.random.default_rng(0).standard_normal(16000) * 500).astype("<i2").tobytes()
for i in range(0, len(pcm), 3200):
    rec.AcceptWaveform(pcm[i:i + 3200])
    assert "partial" in json.loads(rec.PartialResult())
res = json.loads(rec.FinalResult())
assert "text" in res
assert not any(m == "jax" or m.startswith(("jax.", "vosk_tpu.")) for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_grammar_decoders_are_bounded(models, monkeypatch):
    """Runtime-grammar decoders sit in a least-recently-used cache of
    GRAMMAR_DECODERS; the same grammar reuses its decoder."""
    from vosk_tpu_torch.io import native

    tm = models[1]
    monkeypatch.setattr(native, "GRAMMAR_DECODERS", 2)
    grammars = [json.dumps(g) for g in (["one two"], ["three"], ["four five"])]
    decs = [vosk_tpu_torch.KaldiRecognizer(tm, 16000, g)._rec.dec for g in grammars]
    cache = tm._model._grammar_decoders
    assert list(cache) == grammars[1:] and len(set(map(id, decs))) == 3
    assert vosk_tpu_torch.KaldiRecognizer(tm, 16000, grammars[2])._rec.dec is decs[2]
    assert vosk_tpu_torch.KaldiRecognizer(tm, 16000)._rec.dec is tm._model.shared_decoder()


def test_concurrent_recognizers_match_sequential(models):
    """Recognizers of one model share its decoder; driven from more threads
    than cores, with a short switch interval, each gives what it gives
    alone."""
    import threading

    tm = models[1]
    datas = [_pcm(_wav(w, 70 + i)) for i, w in
             enumerate([["one", "two"], ["three"], ["four", "five"], ["six"],
                        ["seven", "zero"], ["two", "six"]] * 2)]

    def run(data):
        out, _ = _drive(vosk_tpu_torch, tm, _split(data, 3200), partial=True,
                        setup=lambda r: r.SetWords(True))
        return out

    want = [run(d) for d in datas]
    got = [None] * len(datas)

    def worker(i):
        got[i] = run(datas[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(datas))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == want
