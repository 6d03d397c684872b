"""vosk_tpu_torch's recipe path on the CPU: the host copies (WER scoring,
the flat-start GMM aligner, the toy corpus synthesis) against their
vosk_tpu sources, and models trained by the port end to end: a chain toy
model from `utils/toydata.build_toy_model` must decode held-out words at
WER <= 0.15 (the bound tests/test_chain.py puts on the source) and open in
vosk_tpu.Model with the same words; the recipe (`training/recipe.py`) must
run its six stages and score its dev set under the same bound.

The toy model is trained once per module into pytest's temp dir.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import vosk_tpu
import vosk_tpu_torch
from vosk_tpu.training import gmm as j_gmm
from vosk_tpu.utils import toydata as j_toydata
from vosk_tpu.utils import wer as j_wer
from vosk_tpu_torch.graph.builder import Lexicon
from vosk_tpu_torch.runtime import native_lattice
from vosk_tpu_torch.training import gmm, recipe
from vosk_tpu_torch.utils import toydata, wer


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Finishing loads core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


@pytest.fixture(scope="module")
def chain_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("toy_chain") / "model"
    toydata.build_toy_model(str(path), train_steps=400, objective="chain", device="cpu")
    return str(path)


def _dev_set():
    """tests/test_chain.py's held-out corpus: 4 utterances of 4 words."""
    rng = np.random.default_rng(99)
    out = []
    for i in range(4):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))] for _ in range(4)]
        out.append((ws, toydata.make_test_wav(ws, seed=700 + i)))
    return out


def _decode(pkg, model, wav):
    rec = pkg.KaldiRecognizer(model, 16000)
    rec.AcceptWaveform(np.clip(wav, -32768, 32767).astype("<i2"))
    return json.loads(rec.FinalResult())["text"].split()


def test_port_trained_chain_model_decodes(chain_dir):
    model = vosk_tpu_torch.Model(chain_dir, device="cpu")
    dev = _dev_set()
    hyps = [_decode(vosk_tpu_torch, model, wav) for _, wav in dev]
    refs = [ws for ws, _ in dev]
    assert wer.score_corpus(refs, hyps).wer <= 0.15, (refs, hyps)


def test_port_trained_model_opens_in_vosk_tpu(chain_dir):
    """The trainers return the source's parameter dict, so the directory
    the port writes is the source's format: vosk_tpu decodes the same
    words."""
    jm = vosk_tpu.Model(chain_dir)
    tm = vosk_tpu_torch.Model(chain_dir, device="cpu")
    for ws, wav in _dev_set():
        want = _decode(vosk_tpu, jm, wav)
        assert _decode(vosk_tpu_torch, tm, wav) == want
        assert want, ws


def test_recipe_demo_on_the_cpu(tmp_path):
    """The demo recipe (24 train, 6 dev utterances, chain, 400 steps): the
    six stages in order, RESULTS.json written, dev WER <= 0.15."""
    lines = []
    out = tmp_path / "demo"
    rep = recipe.demo(str(out), "chain", device="cpu", log=lines.append)
    stages = [ln.split(":")[0] for ln in lines if ln.startswith("stage")]
    assert stages == [f"stage {i}" for i in range(6)], lines
    assert json.loads((out / "RESULTS.json").read_text()) == rep
    assert rep["sentences"] == 6 and rep["ref_words"] == 24
    assert rep["wer"] <= 0.15, rep


def test_recipe_cli_parses_the_device(monkeypatch):
    seen = []
    monkeypatch.setattr(recipe, "demo", lambda *a: seen.append(a))
    recipe.main(["/x", "ce", "--device", "cpu"])
    recipe.main([])
    assert seen == [("/x", "ce", "cpu"), (None, "chain", "cuda")]


def _model_dir_equal_but_am(a, b):
    """Two native model dirs hold the same files, each array equal, but
    for the AM's trained values (same keys, shapes and dtypes)."""
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    for f in sorted(a.iterdir()):
        if f.suffix == ".npz":
            x, y = np.load(f), np.load(b / f.name)
            assert sorted(x.files) == sorted(y.files), f.name
            for k in x.files:
                assert x[k].shape == y[k].shape and x[k].dtype == y[k].dtype, (f.name, k)
                if f.name != "am.npz":
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{f.name} {k}")
        else:
            assert f.read_bytes() == (b / f.name).read_bytes(), f.name


@pytest.mark.parametrize("which", ["toy", "big"])
def test_model_builders_write_the_source_dirs(tmp_path, which):
    """build_toy_model and build_big_model (2 training steps) write the
    source's files: the same config, graph, maps, G, symbols and lexicon,
    and an AM with the source's keys and shapes."""
    if which == "toy":
        toydata.build_toy_model(str(tmp_path / "t"), train_steps=2, device="cpu")
        j_toydata.build_toy_model(str(tmp_path / "j"), train_steps=2)
    else:
        kw = dict(train_steps=2, n_train_utts=3, lm_sentences=40)
        lang = toydata.build_big_language(n_words=40, n_phones=8, homophone_pairs=3)
        toydata.build_big_model(str(tmp_path / "t"), lang, device="cpu", **kw)
        j_toydata.build_big_model(str(tmp_path / "j"), j_toydata.build_big_language(
            n_words=40, n_phones=8, homophone_pairs=3), **kw)
    _model_dir_equal_but_am(tmp_path / "t", tmp_path / "j")


@pytest.mark.slow
def test_recipe_trains_from_transcripts_only(tmp_path):
    """run_recipe with phn=None bootstraps its own alignments (the
    flat-start GMM) and still produces a decodable model (the source's
    tests/test_gmm_align.py:68, slow there too)."""
    rng = np.random.default_rng(1)
    words, phones = toydata.build_symbols()
    ex = toydata.make_extractor(device="cpu")
    train, dev = [], []
    for _ in range(20):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))] for _ in range(5)]
        wav, _ = toydata.synth_utterance(ws, rng)
        train.append((ws, wav, None))
    for _ in range(5):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))] for _ in range(4)]
        wav, _ = toydata.synth_utterance(ws, rng)
        dev.append((ws, wav))
    out = str(tmp_path / "flatstart_model")
    rep = recipe.run_recipe(
        recipe.RecipeConfig(out_dir=out, objective="ce", train_steps=300, device="cpu"),
        train, dev, toydata.toy_lexicon(words, phones), words, phones, ex,
        toydata.SIL_PHONE, log=lambda s: None,
    )
    assert os.path.exists(os.path.join(out, "RESULTS.json"))
    assert rep["wer"] <= 0.30, rep


# --------------------------------------------------------------- host copies

@pytest.fixture(scope="module")
def flat_start():
    """tests/test_gmm_align.py's corpus (10 utterances, 6 EM iterations)
    aligned by both packages from the same features (the port's extractor
    on the CPU; the source reads its tensors as arrays), with the oracle."""
    rng = np.random.default_rng(0)
    words, _ = toydata.build_symbols()
    ex = toydata.make_extractor(device="cpu")
    wavs, trans, oracle = [], [], []
    for _ in range(10):
        ws = [toydata.WORDS[rng.integers(0, len(toydata.WORDS))] for _ in range(4)]
        wav, phn = toydata.synth_utterance(ws, rng)
        wavs.append(wav)
        trans.append([words.find(w) for w in ws])
        oracle.append(phn)
    prons = {words.find(w): [list(p)] for w, p in toydata.WORD_PHONES.items()}
    args = (wavs, trans, prons)
    kw = dict(num_phones=len(toydata.build_symbols()[1]), sil_phone=toydata.SIL_PHONE,
              extractor=ex)
    port = gmm.flat_start_align(*args, cfg=gmm.GmmConfig(num_iters=6), **kw)
    source = j_gmm.flat_start_align(*args, cfg=j_gmm.GmmConfig(num_iters=6), **kw)
    return port, source, oracle


def test_flat_start_align_copy(flat_start):
    port, source, _ = flat_start
    assert len(port) == len(source)
    for a, b in zip(port, source):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_flat_start_alignment_matches_oracle(flat_start):
    """The port's aligner lands above 0.80 of the samples on the oracle
    phone, as tests/test_gmm_align.py:65 requires of the source."""
    port, _, oracle = flat_start
    agree = sum(int((a[:min(len(a), len(o))] == o[:min(len(a), len(o))]).sum())
                for a, o in zip(port, oracle))
    total = sum(min(len(a), len(o)) for a, o in zip(port, oracle))
    assert agree / total > 0.80, agree / total


def test_viterbi_align_copy():
    rng = np.random.default_rng(5)
    ll = rng.standard_normal((40, 7))
    opt = np.array([True, False, False, True, False, False, True])
    np.testing.assert_array_equal(gmm.viterbi_align(ll, opt, np.log(0.7), np.log(0.3)),
                                  j_gmm.viterbi_align(ll, opt, np.log(0.7), np.log(0.3)))


def test_wer_copy():
    rng = np.random.default_rng(3)
    vocab = ["a", "b", "c", "d", "e"]
    refs = [list(rng.choice(vocab, rng.integers(0, 8))) for _ in range(40)]
    hyps = [list(rng.choice(vocab, rng.integers(0, 8))) for _ in range(40)]
    for r, h in zip(refs, hyps):
        assert dataclasses.asdict(wer.align(r, h)) == dataclasses.asdict(j_wer.align(r, h))
    assert wer.score_corpus(refs, hyps).as_dict() == j_wer.score_corpus(refs, hyps).as_dict()
    assert wer.wer(refs, hyps) == j_wer.wer(refs, hyps)
    with pytest.raises(ValueError):
        wer.score_corpus(refs, hyps[:-1])


def _names(table):
    return [table.name(i) for i in range(len(table))]


def test_toydata_synthesis_copy():
    for ws in (["one", "five"], ["seven", "zero", "three"]):
        for sil in (True, False):
            a, pa = toydata.synth_utterance(ws, np.random.default_rng(4), sil)
            b, pb = j_toydata.synth_utterance(ws, np.random.default_rng(4), sil)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(toydata.make_test_wav(ws, seed=9),
                                      j_toydata.make_test_wav(ws, seed=9))
    lang = toydata.build_big_language(n_words=50, n_phones=9, homophone_pairs=4, seed=2)
    jlang = j_toydata.build_big_language(n_words=50, n_phones=9, homophone_pairs=4, seed=2)
    assert lang.word_phones == jlang.word_phones and lang.tone_freqs == jlang.tone_freqs
    assert lang.sil_phone == jlang.sil_phone == lang.n_phones
    assert _names(lang.words) == _names(jlang.words)
    ws = [lang.words.name(i) for i in (1, 7, 30)]
    a, pa = toydata.synth_utterance_lang(lang, ws, np.random.default_rng(6))
    b, pb = j_toydata.synth_utterance_lang(jlang, ws, np.random.default_rng(6))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pa, pb)
    (w, p), (jw, jp) = toydata.build_symbols(), j_toydata.build_symbols()
    assert _names(w) == _names(jw) and _names(p) == _names(jp)


def test_aligned_batch_is_the_source_data_prep():
    """aligned_batch is the padding and centre-sample labelling the
    source's builders and recipe repeat inline (toydata.py:317-345)."""
    rng = np.random.default_rng(8)
    ex = toydata.make_extractor(device="cpu")
    utts = [toydata.synth_utterance([toydata.WORDS[i], toydata.WORDS[i + 2]], rng)
            for i in range(3)]
    fpad, lpad = toydata.aligned_batch(ex, utts)
    fo = ex.frame_opts
    for i, (wav, phn) in enumerate(utts):
        feats = ex.extract(wav[None])[0].numpy()
        T = feats.shape[0]
        centers = np.clip(np.arange(-(-T // 3)) * 3 * fo.window_shift + fo.window_size // 2,
                          0, len(phn) - 1)
        np.testing.assert_array_equal(fpad[i, :T], feats)
        assert (fpad[i, T:] == feats[-1]).all()
        np.testing.assert_array_equal(lpad[i, :len(centers)], phn[centers] - 1)
        assert (lpad[i, len(centers):] == phn[centers[-1]] - 1).all()
    assert fpad.dtype == np.float32 and lpad.dtype == np.int64


def test_toy_lexicon_is_the_source_recipe_lexicon():
    words, phones = toydata.build_symbols()
    lex = toydata.toy_lexicon(words, phones)
    want = Lexicon(words=words, phones=phones,
                   prons={words.find(w): [list(p)] for w, p in toydata.WORD_PHONES.items()},
                   silence_phone=toydata.SIL_PHONE, silence_cost=0.7)
    assert lex == want
