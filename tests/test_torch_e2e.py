"""vosk_tpu_torch.BatchModel / BatchRecognizer against vosk_tpu's, end to end.

The toy model (v4/packed16 decoder, f32 AM), built once per session into
the session's own temp dir, serves both packages on the CPU.  Interleaved
streams, one stream that endpoints between two segments, and noise streams
whose MBR keeps no word must give identical words and timings, and
confidences within 1e-3; so must a stream sent at 8000 Hz through the
resampler.  A subprocess shows that the port imports and decodes with jax
and vosk_tpu blocked.
"""
import json
import os
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


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("toy") / "model")
    toydata.build_toy_model(path, train_steps=400)
    return path


def _pcm(audio):
    return np.clip(audio, -32768, 32767).astype("<i2").tobytes()


def _run(mod, model_dir, datas, step, rate=16000, **kw):
    bm = mod.BatchModel(model_dir, max_batch_size=4, **kw)
    recs = [mod.BatchRecognizer(bm, rate) for _ in datas]
    pos = [0] * len(datas)
    done = [False] * len(datas)
    while not all(done):
        for i, r in enumerate(recs):
            if done[i]:
                continue
            if pos[i] < len(datas[i]):
                r.AcceptWaveform(datas[i][pos[i]: pos[i] + step])
                pos[i] += step
            else:
                r.FinishStream()
                done[i] = True
    bm.Wait()
    out = []
    for r in recs:
        results = []
        while True:
            x = r.Result()
            if not x:
                break
            results.append(json.loads(x))
        out.append(results)
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [x["text"] for x in g] == [x["text"] for x in w]
        for rg, rw in zip(g, w):
            ag, aw = rg.get("result", []), rw.get("result", [])
            assert [(x["word"], x["start"], x["end"]) for x in ag] == \
                [(x["word"], x["start"], x["end"]) for x in aw]
            for x, y in zip(ag, aw):
                assert abs(x["conf"] - y["conf"]) <= 1e-3


def test_batch_streams_match_jax(toy_dir):
    texts = [["one", "two"], ["seven"], ["zero", "five", "six"]]
    datas = [_pcm(toydata.make_test_wav(t, seed=20 + i)) for i, t in enumerate(texts)]
    want = _run(vosk_tpu, toy_dir, datas, 8000)
    got = _run(vosk_tpu_torch, toy_dir, datas, 8000, device="cpu")
    _assert_same(got, want)
    assert [r[0]["text"] for r in got] == [" ".join(t) for t in texts]


def test_endpointed_segments_match_jax(toy_dir):
    rng = np.random.default_rng(0)
    silence = (60.0 * rng.standard_normal(16000 * 3)).astype(np.float32)
    audio = np.concatenate([toydata.make_test_wav(["one", "two"], seed=40), silence,
                            toydata.make_test_wav(["seven"], seed=41)])
    want = _run(vosk_tpu, toy_dir, [_pcm(audio)], 6400)
    got = _run(vosk_tpu_torch, toy_dir, [_pcm(audio)], 6400, device="cpu")
    _assert_same(got, want)
    assert len(got[0]) >= 2 and got[0][0]["text"] == "one two"


def test_noise_streams_without_mbr_words_match_jax(toy_dir, monkeypatch):
    """Noise makes native MBR keep no word, which sends the source through its
    Python lattice fallback and the port through its native n-best."""
    from vosk_tpu_torch.runtime import native_lattice

    empty = []
    mbr = native_lattice.mbr_native

    def counting_mbr(*a, **k):
        got = mbr(*a, **k)
        empty.append(got is not None and not got[1])
        return got

    monkeypatch.setattr(native_lattice, "mbr_native", counting_mbr)
    rng = np.random.default_rng(3)
    datas = [_pcm(amp * rng.standard_normal(16000 * 2)) for amp in (30, 300, 1000, 3000)]
    want = _run(vosk_tpu, toy_dir, datas, 6400)
    got = _run(vosk_tpu_torch, toy_dir, datas, 6400, device="cpu")
    assert any(empty)
    _assert_same(got, want)


@pytest.mark.parametrize("nbest_cost, want", [
    (12.5, [(12.0, [])]),
    (12.0, [(12.0, [(7, 3, 9, 0.25)])]),
])
def test_wordless_best_path_gives_empty_result(monkeypatch, nbest_cost, want):
    """The native n-best skips word-less paths; when its first path costs more
    than the lattice's best path (MBR's cost), the best path had no word and
    the one-best result is empty, as the source's Python n-best gives it."""
    from types import SimpleNamespace
    from vosk_tpu_torch.runtime import finishing, native_lattice

    monkeypatch.setattr(native_lattice, "mbr_native", lambda *a, **k: (12.0, []))
    monkeypatch.setattr(native_lattice, "nbest_native",
                        lambda *a, **k: [(nbest_cost, [(7, 3, 9, 0.25)])])
    model = SimpleNamespace(config=SimpleNamespace(lattice_beam=6.0), silence_pdfs=[0],
                            g_fst=None)
    fin = finishing.Finisher(model, dec=None)
    assert fin.paths([{}], frontier=None, channel=0, n=1) == want


def test_resampled_input_matches_jax(toy_dir):
    texts = [["two", "seven"], ["six"]]
    datas = [_pcm(resample_offline(toydata.make_test_wav(t, seed=60 + i), 16000, 8000))
             for i, t in enumerate(texts)]
    want = _run(vosk_tpu, toy_dir, datas, 3000, rate=8000)
    got = _run(vosk_tpu_torch, toy_dir, datas, 3000, rate=8000, device="cpu")
    _assert_same(got, want)
    # the 4 kHz band loses some of the toy model's cues: words are found,
    # not always the ones said
    assert all(r[0]["text"] for r in got)


def test_imports_and_decodes_without_jax(toy_dir):
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.modules["vosk_tpu"] = None
import numpy as np
import vosk_tpu_torch
bm = vosk_tpu_torch.BatchModel({toy_dir!r}, max_batch_size=2, device="cpu")
rec = vosk_tpu_torch.BatchRecognizer(bm, 16000)
pcm = (np.random.default_rng(0).standard_normal(16000) * 500).astype("<i2")
rec.AcceptWaveform(pcm.tobytes())
rec.FinishStream()
res = json.loads(rec.Result())
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
