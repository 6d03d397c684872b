"""LM rescoring in vosk_tpu_torch against vosk_tpu, on the CPU.

Host copies held exactly (the same float arithmetic): `BackoffLm` and
`FstLm` scores and final costs on the ARPA of tests/test_rescoring.py and on
a seeded 3-gram from `kaldidata.write_arpa`; `read_carpa` of a file the JAX
package wrote, `write_carpa` byte for byte, `build_carpa_from_arpa` array for
array; `rescore_lattice` with those LMs on the lattices of
tests/test_torch_copies.py's decoded fixture.  The `kaldidata` writers'
files load in both packages.  End to end, on the toy model: a native dir
with g.npz + rescore.arpa and a Kaldi dir with rescore/ give the same JSON
through Model + KaldiRecognizer and BatchModel in both packages (text and
word times identical, confidences within 1e-3); an unparseable G.carpa
warns and decodes without rescoring in both.
"""
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import vosk_tpu
import vosk_tpu_torch
from test_rescoring import ARPA
from test_torch_copies import _lattices_equal, decoded, lattices, small_graph  # noqa: F401
from vosk_tpu.graph import arpa as j_arpa
from vosk_tpu.graph import lattice as j_lattice
from vosk_tpu.graph.fst import SymbolTable as JSymbols
from vosk_tpu.io import kaldi_carpa as j_carpa
from vosk_tpu.io import native as j_native
from vosk_tpu.io.kaldi_export import export_kaldi_dir
from vosk_tpu.models import rnnlm as j_rnnlm
from vosk_tpu.utils import toydata
from vosk_tpu_torch.graph import arpa, lattice
from vosk_tpu_torch.graph.fst import SymbolTable
from vosk_tpu_torch.io import kaldi_carpa, native
from vosk_tpu_torch.models import rnnlm
from vosk_tpu_torch.runtime import native_lattice
from vosk_tpu_torch.utils import kaldidata

NW = 300  # the small graph's vocabulary (tests/test_torch_copies.py)


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


def _words(n):
    names = ["<eps>"] + [f"w{i}" for i in range(1, n + 1)]
    return SymbolTable(names), JSymbols(names)


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """Both packages' LMs from the same files: {name: (port LM, JAX LM)} for
    the toy ARPA ("toy") and a seeded 3-gram over w1..w300 ("arpa", its
    const-ARPA "carpa", its bigram acceptor "g" through g.npz)."""
    d = tmp_path_factory.mktemp("lms")
    (d / "toy.arpa").write_text(ARPA)
    toy_words, _ = toydata.build_symbols()
    tw, jw = _words(NW)
    counts = kaldidata.write_arpa(d / "lm.arpa", tw, seed=1, num_bigrams=3000,
                                  num_trigrams=2000)
    assert counts["unigrams"] == NW + 2 and counts["trigrams"] == 2000
    assert 1000 < counts["bigrams"] <= 3000
    native._save_std_fst(d / "g.npz", kaldidata.bigram_fst(tw, seed=1, num_bigrams=3000,
                                                           num_trigrams=2000))
    j_carpa.write_carpa(j_carpa.build_carpa_from_arpa(d / "lm.arpa", jw), d / "j.carpa")
    toy_t = SymbolTable([toy_words.name(i) for i in range(len(toy_words))])
    return d, {
        "toy": (arpa.BackoffLm.read_arpa(d / "toy.arpa", toy_t),
                j_arpa.BackoffLm.read_arpa(d / "toy.arpa", toy_words)),
        "arpa": (arpa.BackoffLm.read_arpa(d / "lm.arpa", tw),
                 j_arpa.BackoffLm.read_arpa(d / "lm.arpa", jw)),
        "carpa": (kaldi_carpa.read_carpa(d / "j.carpa"), j_carpa.read_carpa(d / "j.carpa")),
        "g": (arpa.FstLm(native._load_std_fst(d / "g.npz")),
              j_arpa.FstLm(j_native._load_std_fst(d / "g.npz"))),
    }


def _walk(lm, rng, hi, n=40):
    """Scores along seeded word sequences: [(cost, state)..., final]."""
    out = []
    for _ in range(n):
        st = lm.initial_state()
        for w in rng.integers(1, hi + 2, int(rng.integers(1, 6))).tolist():
            c, st = lm.score(st, w)
            out.append((c, st))
        out.append(lm.final_cost(st))
    return out


@pytest.mark.parametrize("name", ["toy", "arpa", "carpa", "g"])
def test_lm_scores_copy(lms, name):
    _, got = lms
    t, j = got[name]
    hi = 8 if name == "toy" else NW
    a, b = _walk(t, np.random.default_rng(0), hi), _walk(j, np.random.default_rng(0), hi)
    assert a == b and any(isinstance(x, float) and x != 20.0 for x in b)


def test_carpa_build_write_read_copy(lms, tmp_path):
    d, _ = lms
    tw, jw = _words(NW)
    t, j = kaldi_carpa.build_carpa_from_arpa(d / "lm.arpa", tw), \
        j_carpa.build_carpa_from_arpa(d / "lm.arpa", jw)
    for k in ("bos", "eos", "unk", "order", "num_words"):
        assert getattr(t, k) == getattr(j, k), k
    np.testing.assert_array_equal(t.lm_states, j.lm_states)
    np.testing.assert_array_equal(t.unigram_states, j.unigram_states)
    kaldi_carpa.write_carpa(t, tmp_path / "t.carpa")
    assert (tmp_path / "t.carpa").read_bytes() == (d / "j.carpa").read_bytes()
    back = kaldi_carpa.read_carpa(d / "j.carpa")
    np.testing.assert_array_equal(back.lm_states, j.lm_states)
    with pytest.raises(kaldi_carpa.KaldiReadError):
        (tmp_path / "bad.carpa").write_bytes(b"not a carpa")
        kaldi_carpa.read_carpa(tmp_path / "bad.carpa")


@pytest.mark.parametrize("add", ["none", "arpa", "carpa", "mixture"])
def test_rescore_lattice_copy(lms, lattices, add):  # noqa: F811
    _, got = lms
    for pair in lattices:
        for which in (0, 1):
            outs = []
            for side, mod, mix in ((0, lattice, rnnlm.MixtureLm),
                                   (1, j_lattice, j_rnnlm.MixtureLm)):
                lm = {"none": None, "arpa": got["arpa"][side], "carpa": got["carpa"][side],
                      "mixture": mix([(0.5, got["carpa"][side]), (0.5, got["arpa"][side])])}
                lat = pair[side][which].copy()
                outs.append(mod.rescore_lattice(lat, got["g"][side], lm[add]))
            _lattices_equal(*outs)
            assert outs[0].num_nodes >= pair[0][which].num_nodes


def test_kaldidata_writers_load_in_both(tmp_path):
    """rescore/ and the native rescoring files written by the port's
    writers, read by both packages."""
    from vosk_tpu.io.kaldi_models import raw_fst_to_std as j_raw, read_fst as j_read_fst
    from vosk_tpu_torch.io.kaldi_models import raw_fst_to_std, read_fst

    tw, jw = _words(50)
    m = SimpleNamespace(words=tw)
    info = kaldidata.write_rescore_dir(m, tmp_path, seed=2, num_bigrams=200, num_trigrams=100)
    assert info["g_arcs"] >= 50 + 200 - 30
    t, j = kaldi_carpa.read_carpa(tmp_path / "rescore" / "G.carpa"), \
        j_carpa.read_carpa(tmp_path / "rescore" / "G.carpa")
    np.testing.assert_array_equal(t.lm_states, j.lm_states)
    assert t.order == j.order == 3
    ga = raw_fst_to_std(read_fst(tmp_path / "rescore" / "G.fst"))
    gb = j_raw(j_read_fst(tmp_path / "rescore" / "G.fst"))
    assert (ga.arcs, ga.final, ga.start) == (gb.arcs, gb.final, gb.start)
    kaldidata.write_native_rescoring(m, tmp_path, seed=2, rnnlm_dims=(4, 5),
                                     num_bigrams=200, num_trigrams=100)
    a, b = native._load_std_fst(tmp_path / "g.npz"), j_native._load_std_fst(tmp_path / "g.npz")
    assert (a.arcs, a.final, a.start) == (b.arcs, b.final, b.start)
    # the same bigram as G.fst, whose weights are stored in float32
    assert [[(i, o, n) for i, o, _, n in r] for r in a.arcs] == \
        [[(i, o, n) for i, o, _, n in r] for r in ga.arcs]
    ta = arpa.BackoffLm.read_arpa(tmp_path / "rescore.arpa", tw)
    ja = j_arpa.BackoffLm.read_arpa(tmp_path / "rescore.arpa", jw)
    assert (ta.ngrams, ta.backoffs, ta.order) == (ja.ngrams, ja.backoffs, ja.order)
    jm = j_rnnlm.RnnlmModel.load(tmp_path / "rnnlm")
    tm = rnnlm.RnnlmModel.load(tmp_path / "rnnlm", device="cpu")
    assert (tm.cfg.vocab_size, tm.cfg.embed_dim, tm.cfg.hidden_dim) == (51, 4, 5)
    for k, v in jm.params.items():
        np.testing.assert_array_equal(tm.params[k].numpy(), np.asarray(v))


# ------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("toy") / "model"
    toydata.build_toy_model(str(path), train_steps=400)
    return path


def _pcm(words, seed):
    return np.clip(toydata.make_test_wav(words, seed=seed), -32768, 32767) \
        .astype("<i2").tobytes()


def _assert_same_json(g, w, path="$"):
    if isinstance(w, dict):
        assert isinstance(g, dict) and g.keys() == w.keys(), path
        for k in w:
            if k in ("conf", "confidence"):
                assert abs(g[k] - w[k]) <= 1e-3, (path, k, g[k], w[k])
            else:
                _assert_same_json(g[k], w[k], f"{path}.{k}")
    elif isinstance(w, list):
        assert isinstance(g, list) and len(g) == len(w), path
        for i, (x, y) in enumerate(zip(g, w)):
            _assert_same_json(x, y, f"{path}[{i}]")
    else:
        assert g == w, (path, g, w)


def _stream(mod, model, pcm, alternatives=0):
    rec = mod.KaldiRecognizer(model, 16000)
    rec.SetWords(True)
    rec.SetMaxAlternatives(alternatives)
    out = []
    for i in range(0, len(pcm), 6400):
        if rec.AcceptWaveform(pcm[i: i + 6400]):
            out.append(rec.Result())
    out.append(rec.FinalResult())
    return [json.loads(x) for x in out], rec


def _batch(mod, path, datas, **kw):
    bm = mod.BatchModel(str(path), max_batch_size=2, **kw)
    recs = [mod.BatchRecognizer(bm, 16000) for _ in datas]
    for r, d in zip(recs, datas):
        r.AcceptWaveform(d)
    for r in recs:
        r.FinishStream()
    bm.Wait()
    out = []
    for r in recs:
        while True:
            x = r.Result()
            if not x:
                break
            out.append(json.loads(x))
    return out


def _both(path, alternatives=0):
    jm, tm = vosk_tpu.Model(str(path)), vosk_tpu_torch.Model(str(path), device="cpu")
    pcm = _pcm(["one", "five", "zero", "three"], 91)
    want, _ = _stream(vosk_tpu, jm, pcm, alternatives)
    got, rec = _stream(vosk_tpu_torch, tm, pcm, alternatives)
    _assert_same_json(got, want)
    datas = [_pcm(["six", "four"], 210), _pcm(["two", "seven", "zero"], 211)]
    _assert_same_json(_batch(vosk_tpu_torch, path, datas, device="cpu"),
                      _batch(vosk_tpu, path, datas))
    return got, rec._rec._finisher


@pytest.mark.parametrize("alternatives", [0, 3])
def test_native_dir_with_rescore_arpa_matches_jax(toy_dir, tmp_path, alternatives):
    d = tmp_path / "model"
    shutil.copytree(toy_dir, d)
    (d / "rescore.arpa").write_text(ARPA)
    got, fin = _both(d, alternatives)
    assert fin.rescoring and fin.rescore_stats["lattices"] > 0
    res = got[-1]["alternatives"][0] if alternatives else got[-1]
    assert res["text"] == "one five zero three"


@pytest.fixture(scope="module")
def kaldi_dir(toy_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("kaldi_rescore") / "model"
    export_kaldi_dir(j_native.load_model(toy_dir), d)
    words = SymbolTable.read_text(d / "graph" / "words.txt")
    kaldidata.write_rescore_dir(SimpleNamespace(words=words), d, seed=5, num_bigrams=30,
                                num_trigrams=20)
    return d


def test_kaldi_dir_with_rescore_matches_jax(kaldi_dir):
    _, fin = _both(kaldi_dir)
    assert fin.rescoring and fin.model.rescore_lm.scored > 0
    assert fin.rescore_stats["nodes"] > 0 and fin.rescore_stats["arcs"] > 0


def test_unparseable_carpa_decodes_without_rescoring(kaldi_dir, tmp_path, capsys):
    d = tmp_path / "model"
    shutil.copytree(kaldi_dir, d)
    (d / "rescore" / "G.carpa").write_bytes(b"\x00B<ConstArpaLm> garbage")
    tm = vosk_tpu_torch.Model(str(d), device="cpu")
    assert "rescore/ dir present but not usable" in capsys.readouterr().err
    jm = vosk_tpu.Model(str(d))
    assert "rescore/ dir present but not usable" in capsys.readouterr().err
    for m in (tm, jm):
        assert m._model.rescore_lm is None and m._model.g_fst is None
    pcm = _pcm(["two", "six"], 5)
    want, _ = _stream(vosk_tpu, jm, pcm)
    got, rec = _stream(vosk_tpu_torch, tm, pcm)
    _assert_same_json(got, want)
    assert not rec._rec._finisher.rescoring and got[-1]["text"] == "two six"
