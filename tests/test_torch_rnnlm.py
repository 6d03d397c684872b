"""RNNLMs and the recurrent nnet3 evaluator in vosk_tpu_torch against vosk_tpu,
on the CPU.

The native GRU LM (parameters carried across with `params_from_numpy`)
against `jax.jit` of the source's step: h and log-probs within rtol = atol
= 1e-5, rescorer and mixture scores within 1e-5.  LstmNonlinearityComponent
within 1e-6, the recurrent unroll of tests/test_kaldi_rnnlm.py's LSTM net
within 1e-5.  Kaldi rnnlm/ dirs (a TDNN and an LSTM written by the JAX
writer, and the TDNN-LSTM recipe graph written by the port's
`kaldidata.write_kaldi_rnnlm_dir`) load in both packages; scores within
1e-4, the sparse word-embedding product within rtol 1e-6 of the source's
dense one.  End to end, on the toy model: a native dir with g.npz,
rescore.arpa and a GRU rnnlm/, and a Kaldi dir with rescore/ and an LSTM
rnnlm/ (one stream folds), give the same text and word times in both
packages through Model + KaldiRecognizer and BatchModel, confidences
within 1e-3.
"""
import io
import json
import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import vosk_tpu
import vosk_tpu_torch
from test_kaldi_rnnlm import EMB, _build_lstm_net
from test_rescoring import ARPA
from vosk_tpu.io import nnet3 as j3
from vosk_tpu.io import native as j_native
from vosk_tpu.io.kaldi_export import export_kaldi_dir, tdnnf_to_nnet3
from vosk_tpu.io.kaldi_rnnlm import KaldiRnnlmRescorer as JKaldiRescorer
from vosk_tpu.io.kaldi_rnnlm import read_rnnlm_dir as j_read_rnnlm_dir
from vosk_tpu.io.kaldiio import BinaryWriter as JWriter
from vosk_tpu.models import rnnlm as jr
from vosk_tpu.models.tdnnf import TdnnfConfig, init_params
from vosk_tpu.utils import toydata
from vosk_tpu_torch.graph.fst import SymbolTable
from vosk_tpu_torch.io import kaldi_rnnlm, nnet3 as t3
from vosk_tpu_torch.io.kaldiio import BinaryReader
from vosk_tpu_torch.models import rnnlm as tr
from vosk_tpu_torch.runtime import native_lattice
from vosk_tpu_torch.utils import kaldidata

V, FEATS = 10, 12


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


# ------------------------------------------------------------ native GRU LM


@pytest.fixture(scope="module")
def gru():
    cfg = jr.RnnlmConfig(vocab_size=V, embed_dim=6, hidden_dim=9)
    params = jr.init_rnnlm_params(cfg, seed=3)
    tcfg = tr.RnnlmConfig(vocab_size=V, embed_dim=6, hidden_dim=9)
    tp = tr.init_rnnlm_params(tcfg, seed=3)
    for k in params:
        np.testing.assert_array_equal(tp[k], params[k], err_msg=k)
    return jr.RnnlmModel(cfg, params), tr.RnnlmModel(tcfg, params, device="cpu")


def test_rnnlm_step_matches_jax(gru):
    jm, tm = gru
    step = jax.jit(jm._step_impl)
    jh, th = jm.init_hidden(), tm.init_hidden()
    for w in (jm.cfg.bos, 3, 9, 0, 42, jm.cfg.eos, 5):
        jh, jl = step(jm.params, jh, jm._wid(w))
        th, tl = tm.step(th, w)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_rnnlm_rescorer_and_mixture_match_jax(gru, tmp_path):
    jm, tm = gru
    tm.save(tmp_path / "t")
    back = tr.RnnlmModel.load(tmp_path / "t", device="cpu")
    assert back.cfg == tm.cfg and jr.RnnlmModel.load(tmp_path / "t").cfg.vocab_size == V
    jres, tres = jr.RnnlmRescorer(jm), tr.RnnlmRescorer(back)
    jmix = jr.MixtureLm([(0.5, jres), (0.5, jr.RnnlmRescorer(jm, lm_order=2))])
    tmix = tr.MixtureLm([(0.5, tres), (0.5, tr.RnnlmRescorer(back, lm_order=2))])
    rng = np.random.default_rng(0)
    for _ in range(6):
        js, ts, jx, tx = jres.initial_state(), tres.initial_state(), \
            jmix.initial_state(), tmix.initial_state()
        for w in rng.integers(1, V, 5).tolist():
            (jc, js), (tc, ts) = jres.score(js, w), tres.score(ts, w)
            assert ts == js and abs(tc - jc) <= 1e-5
            (jc, jx), (tc, tx) = jmix.score(jx, w), tmix.score(tx, w)
            assert tx == jx and abs(tc - jc) <= 1e-5
        assert abs(tres.final_cost(ts) - jres.final_cost(js)) <= 1e-5
        assert abs(tmix.final_cost(tx) - jmix.final_cost(jx)) <= 1e-5
    n = tres.evaluated
    tres.clear()
    assert list(tres._cache) == [()] and n > 1
    assert isinstance(tres._cache[()][1], np.ndarray)  # rows kept on the host


# ----------------------------------------------------- nnet3: the LSTM parts


def test_lstm_nonlinearity_forward_matches_jax():
    rng = np.random.default_rng(1)
    jc = j3.LstmNonlinearityComponent(rng.standard_normal((3, 7)).astype(np.float32))
    buf = io.BytesIO()
    jc.write(JWriter(buf))
    tc = t3.read_component(BinaryReader(io.BytesIO(buf.getvalue())))
    assert isinstance(tc, t3.LstmNonlinearityComponent) and tc.output_dim() == 14
    x = rng.standard_normal((2, 4, 35)).astype(np.float32)
    got = tc.forward(torch.from_numpy(x), tc.tensors("cpu")).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.forward(x)), rtol=1e-6, atol=1e-6)


def _port_net(jnet):
    buf = io.BytesIO()
    jnet.write(JWriter(buf))
    return t3.Nnet3.read(BinaryReader(io.BytesIO(buf.getvalue())))


@pytest.mark.parametrize("T", [1, 6])
def test_recurrent_evaluate_matches_jax(T):
    rng = np.random.default_rng(7)
    jnet, _ = _build_lstm_net(rng)
    tnet = _port_net(jnet)
    assert tnet.has_recurrence()
    x = rng.standard_normal((3, T, EMB)).astype(np.float32)
    got = tnet.evaluate({"input": torch.from_numpy(x)}, t3.net_tensors(tnet, "cpu")).numpy()
    assert got.shape == (3, T, EMB)
    for b in range(3):
        want = np.asarray(jnet._evaluate_recurrent({"input": x[b]}))
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ Kaldi rnnlm/


def _write_rnnlm_dir(d, kind, seed=0):
    """An rnnlm/ dir over V words + <s>=V, </s>=V+1, <brk>=V+2, written by the
    JAX package's writers: 2-4 seeded sparse features a word (one line
    lists a feature twice; the last value counts), and a TDNN or an LSTM
    final.raw whose input is the embedding dim."""
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True)
    lines = []
    for w in range(V + 3):
        k = int(rng.integers(2, 5))
        idx = rng.choice(FEATS, k, replace=False)
        pairs = [f"{i} {v:.5f}" for i, v in zip(idx, rng.uniform(-1, 1, k))]
        if w == 4:
            pairs.append(f"{idx[0]} 0.25")
        lines.append(f"{w}  " + " ".join(pairs))
    (d / "word_feats.txt").write_text("\n".join(lines) + "\n")
    femb = rng.standard_normal((FEATS, EMB)).astype(np.float32)
    with open(d / "feat_embedding.final.mat", "wb") as f:
        f.write(b"\x00B")
        JWriter(f).write_matrix(femb)
    (d / "special_symbol_opts.conf").write_text(
        f"--bos-symbol={V}\n--eos-symbol={V + 1}\n--brk-symbol={V + 2}\n")
    if kind == "tdnn":
        cfg = TdnnfConfig(feat_dim=EMB, hidden_dim=16, bottleneck_dim=8, prefinal_dim=8,
                          num_pdfs=EMB, time_strides=(1, 0), subsample=1)
        net = tdnnf_to_nnet3(cfg, init_params(cfg, seed=1))
    else:
        net, _ = _build_lstm_net(rng)
    with open(d / "final.raw", "wb") as f:
        f.write(b"\x00B")
        net.write(JWriter(f))


def _histories(rng, bos, n=12):
    out = [(bos,)]
    for _ in range(n):
        out.append((bos,) + tuple(rng.integers(1, V, int(rng.integers(1, 4))).tolist()))
    return out


def _assert_rescorers_agree(jres, tres, words_hi, seed=0):
    rng = np.random.default_rng(seed)
    assert (tres.left_context, tres.right_context) == (jres.left_context,
                                                       jres.right_context)
    for st in _histories(rng, jres.initial_state()[0]):
        assert tres.initial_state() == jres.initial_state()
        for w in list(range(1, words_hi)) + [words_hi + 5]:
            (jc, js), (tc, ts) = jres.score(st, w), tres.score(st, w)
            assert ts == js and abs(tc - jc) <= 1e-4, (st, w, tc, jc)
        assert abs(tres.final_cost(st) - jres.final_cost(st)) <= 1e-4
    assert tres.evaluated == len(tres._cache) > 0


@pytest.mark.parametrize("kind", ["tdnn", "lstm"])
def test_kaldi_rnnlm_dir_matches_jax(tmp_path, kind):
    _write_rnnlm_dir(tmp_path / "rnnlm", kind)
    jlm = j_read_rnnlm_dir(tmp_path / "rnnlm")
    tlm = kaldi_rnnlm.read_rnnlm_dir(tmp_path / "rnnlm")
    assert (tlm.bos, tlm.eos, tlm.brk) == (jlm.bos, jlm.eos, jlm.brk) == (V, V + 1, V + 2)
    assert tlm.net.has_recurrence() == (kind == "lstm")
    emb = kaldi_rnnlm.word_embedding(tlm, "cpu").numpy()
    np.testing.assert_allclose(emb, jlm.word_embedding, rtol=1e-6,
                               atol=1e-6 * np.abs(jlm.word_embedding).max())
    tres = kaldi_rnnlm.KaldiRnnlmRescorer(tlm, device="cpu")
    jres = JKaldiRescorer(jlm)
    if kind == "tdnn":
        assert tres.left_context > 0  # <brk> padding on the left runs
    _assert_rescorers_agree(jres, tres, V)


def test_kaldidata_rnnlm_dir_loads_in_both(tmp_path):
    """The TDNN-LSTM recipe graph (two fast-lstmp layers, BackpropTruncation,
    dim-range nodes) written by the port's writer scores alike in both
    packages."""
    words = SymbolTable(["<eps>"] + [f"w{i}" for i in range(1, V)])
    info = kaldidata.write_kaldi_rnnlm_dir(tmp_path / "rnnlm", words, seed=2,
                                           embedding_dim=16, cell_dim=8, recurrent_dim=4,
                                           nonrecurrent_dim=3, num_features=40,
                                           num_frequent=6)
    assert info["words"] == V + 3 and 2 * info["words"] <= info["nonzeros"] <= 6 * info["words"]
    jlm = j_read_rnnlm_dir(tmp_path / "rnnlm")
    tlm = kaldi_rnnlm.read_rnnlm_dir(tmp_path / "rnnlm")
    assert tlm.net.node_order == jlm.net.node_order and tlm.net.has_recurrence()
    assert {type(c).__name__ for c in jlm.net.components.values()} == {
        "AffineComponent", "NonlinComponent", "LstmNonlinearityComponent",
        "IdentityComponent"}
    _assert_rescorers_agree(JKaldiRescorer(jlm),
                            kaldi_rnnlm.KaldiRnnlmRescorer(tlm, device="cpu"), V, seed=1)


# ------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("toy") / "model"
    toydata.build_toy_model(str(path), train_steps=400)
    return path


def _pcm(audio):
    return np.clip(audio, -32768, 32767).astype("<i2").tobytes()


def _same_items(got, want):
    """Same text and word times; confidences within 1e-3."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        if "alternatives" in w:
            g, w = g["alternatives"][0], w["alternatives"][0]
        key = "partial" if "partial" in w else "text"
        assert g[key] == w[key]
        gw, ww = g.get("result", g.get("partial_result", [])), \
            w.get("result", w.get("partial_result", []))
        assert [(x["word"], x["start"], x["end"]) for x in gw] == \
            [(x["word"], x["start"], x["end"]) for x in ww]
        for x, y in zip(gw, ww):
            if "conf" in y:
                assert abs(x["conf"] - y["conf"]) <= 1e-3


def _stream(mod, model, pieces, setup=None):
    rec = mod.KaldiRecognizer(model, 16000)
    rec.SetWords(True)
    if setup is not None:
        setup(rec)
    out = []
    for p in pieces:
        if rec.AcceptWaveform(p):
            out.append(rec.Result())
        else:
            out.append(rec.PartialResult())
    out.append(rec.FinalResult())
    return out, rec


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
            out.append(x)
    return out


def test_native_dir_with_gru_rnnlm_matches_jax(toy_dir, tmp_path):
    """g.npz (the toy's graph LM) + rescore.arpa + a seeded GRU rnnlm/."""
    d = tmp_path / "model"
    shutil.copytree(toy_dir, d)
    (d / "rescore.arpa").write_text(ARPA)
    words = j_native.load_model(toy_dir).words
    cfg = tr.RnnlmConfig(vocab_size=len(words), embed_dim=8, hidden_dim=12)
    tr.save_rnnlm(d / "rnnlm", cfg, tr.init_rnnlm_params(cfg, seed=4))
    jm, tm = vosk_tpu.Model(str(d)), vosk_tpu_torch.Model(str(d), device="cpu")
    assert tm._model.rnnlm is not None and tm._model.g_fst is not None
    pcm = _pcm(toydata.make_test_wav(["two", "five", "one"], seed=31))
    pieces = [pcm[i: i + 8000] for i in range(0, len(pcm), 8000)]
    want, _ = _stream(vosk_tpu, jm, pieces)
    got, rec = _stream(vosk_tpu_torch, tm, pieces)
    _same_items(got, want)
    fin = rec._rec._finisher
    assert fin.rescoring and fin.rescore_stats["lattices"] > 0
    assert fin._rnn_rescorer.evaluated > 1
    datas = [_pcm(toydata.make_test_wav(w, seed=40 + i))
             for i, w in enumerate((["six", "four"], ["seven", "zero", "three"]))]
    _same_items(_batch(vosk_tpu_torch, d, datas, device="cpu"), _batch(vosk_tpu, d, datas))


@pytest.fixture(scope="module")
def kaldi_rescored_dir(toy_dir, tmp_path_factory):
    """The toy exported as a Kaldi dir with rescore/ and an LSTM rnnlm/
    written by the port's kaldidata writers."""
    d = tmp_path_factory.mktemp("kaldi_rnnlm") / "model"
    toy = j_native.load_model(toy_dir)
    export_kaldi_dir(toy, d)
    words = SymbolTable.read_text(d / "graph" / "words.txt")
    kaldidata.write_rescore_dir(SimpleNamespace(words=words), d, seed=3, num_bigrams=30,
                                num_trigrams=20)
    kaldidata.write_kaldi_rnnlm_dir(d / "rnnlm", words, seed=3, embedding_dim=16,
                                    cell_dim=8, recurrent_dim=4, nonrecurrent_dim=4,
                                    num_features=60, num_frequent=8)
    return d


def test_kaldi_dir_with_lstm_rnnlm_folds_and_matches_jax(kaldi_rescored_dir):
    words = ["five", "six", "seven", "zero", "one", "two"] * 2
    wav, _ = toydata.synth_utterance(words, np.random.default_rng(7), sil_between=False)
    pcm = _pcm(wav)
    pieces = [pcm[i: i + 6400] for i in range(0, len(pcm), 6400)]

    def setup(r):
        r._rec.max_window_frames = 40
        r._rec.keep_window_frames = 24

    jm = vosk_tpu.Model(str(kaldi_rescored_dir))
    tm = vosk_tpu_torch.Model(str(kaldi_rescored_dir), device="cpu")
    assert tm._model.rnnlm_rescorer is not None and tm._model.rescore_lm is not None
    want, _ = _stream(vosk_tpu, jm, pieces, setup)
    got, rec = _stream(vosk_tpu_torch, tm, pieces, setup)
    _same_items(got, want)
    assert rec._rec._folded_frames > 0, "folding never engaged"
    assert tm._model.rnnlm_rescorer.evaluated > 0 and tm._model.rescore_lm.scored > 0
    assert json.loads(got[-1])["text"]
    datas = [_pcm(toydata.make_test_wav(w, seed=50 + i))
             for i, w in enumerate((["one", "three"], ["four", "zero", "six"]))]
    _same_items(_batch(vosk_tpu_torch, kaldi_rescored_dir, datas, device="cpu"),
                _batch(vosk_tpu, kaldi_rescored_dir, datas))
