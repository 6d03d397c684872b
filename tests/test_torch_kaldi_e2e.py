"""Kaldi model directories through vosk_tpu_torch against vosk_tpu, on the CPU.

The toy model, trained once per module into pytest's temp dir, is exported
by the JAX package's exporter into the Kaldi layouts the port now reads:
an HCLG directory, the same with an i-vector extractor grafted onto the
AM's first layer (seeded non-zero weights, so the i-vector moves the
output) and decoded-silence weighting on, a split HCLr/Gr directory, and
an HCLG directory with `graph/phones/word_boundary.int`.  Both packages
get the same PCM in the same pieces; every result must have identical
text, words, starts and ends, and confidences within 1e-3 (the AMs differ
at float rounding).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vosk_tpu
import vosk_tpu_torch
from vosk_tpu.io import native as j_native
from vosk_tpu.io import nnet3 as j3
from vosk_tpu.io.kaldi_export import (
    build_transition_model,
    export_kaldi_dir,
    export_kaldi_split_dir,
    tdnnf_to_nnet3,
)
from vosk_tpu.io.kaldi_ivector import (
    DiagGmm,
    IvectorDirConfig,
    IvectorExtractor,
    write_ivector_dir,
)
from vosk_tpu.io.kaldiio import BinaryWriter
from vosk_tpu.runtime.finishing import Finisher as JFinisher
from vosk_tpu.utils import toydata
from vosk_tpu_torch.runtime import native_lattice

REPO = Path(__file__).resolve().parents[1]
IVD, UBM_D, SPLICE = 6, 5, 2


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


def _graft_ivector(toy, out_dir):
    """The AM of `toy` with an i-vector input appended to tdnn1.affine
    (seeded non-zero weights), and an ivector/ dir for the toy MFCCs."""
    tm = build_transition_model(len(toy.phones) - 1, toy.topology.self_loop_prob)
    net = tdnnf_to_nnet3(toy.am_config, toy.am_params)
    net._parse_config_line(f"input-node name=ivector dim={IVD}")
    net._parse_config_line(
        "component-node name=tdnn1.affine component=tdnn1.affine "
        "input=Append(Offset(input, -1), input, Offset(input, 1), "
        "ReplaceIndex(ivector, t, 0))")
    aff = net.components["tdnn1.affine"]
    rng = np.random.default_rng(11)
    aff.linear = np.concatenate(
        [aff.linear, (rng.standard_normal((aff.linear.shape[0], IVD)) * 0.05)
         .astype(np.float32)], axis=1)
    with open(out_dir / "am" / "final.mdl", "wb") as f:
        f.write(b"\x00B")
        w = BinaryWriter(f)
        tm.write(w)
        j3.AmNnetSimple(net, np.zeros(0, np.float32)).write(w)
    din = toy.am_config.feat_dim
    gmm = DiagGmm(np.zeros(4, np.float32), np.full(4, 0.25, np.float32),
                  rng.standard_normal((4, UBM_D)).astype(np.float32),
                  np.ones((4, UBM_D), np.float32))
    gmm.gconsts = gmm.compute_gconsts()
    A = rng.standard_normal((4, UBM_D, UBM_D)).astype(np.float32) * 0.2
    sig = np.einsum("gij,gkj->gik", A, A) + np.eye(UBM_D, dtype=np.float32)
    ie = IvectorExtractor(M=(rng.standard_normal((4, UBM_D, IVD)) * 0.3).astype(np.float32),
                          sigma_inv=sig.astype(np.float32), prior_offset=2.0,
                          w_vec=np.full(4, 0.25, np.float32))
    lda = (rng.standard_normal((UBM_D, din * (2 * SPLICE + 1) + 1)) * 0.05).astype(np.float32)
    cmvn = np.zeros((2, din + 1), np.float64)
    cmvn[0, -1] = 1.0
    write_ivector_dir(out_dir / "ivector", IvectorDirConfig(
        dubm=gmm, extractor=ie, lda=lda, global_cmvn=cmvn,
        splice_left=SPLICE, splice_right=SPLICE))
    conf = out_dir / "conf" / "model.conf"
    conf.write_text(conf.read_text() + "--ivector-silence-weighting.silence-weight=0.001\n"
                    "--ivector-silence-weighting.silence-phones=9\n")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("kaldi")
    toy_dir = root / "toy"
    toydata.build_toy_model(str(toy_dir), train_steps=400)
    toy = j_native.load_model(toy_dir)
    out = {"hclg": root / "hclg", "split": root / "split"}
    export_kaldi_dir(toy, out["hclg"])
    export_kaldi_split_dir(toy, out["split"])
    out["ivector"] = root / "ivector"
    shutil.copytree(out["hclg"], out["ivector"])
    _graft_ivector(toy, out["ivector"])
    out["word_boundary"] = root / "word_boundary"
    shutil.copytree(out["hclg"], out["word_boundary"])
    wb = "\n".join([f"{p} singleton" for p in range(1, 9)] + ["9 nonword"]) + "\n"
    (out["word_boundary"] / "graph" / "phones" / "word_boundary.int").write_text(wb)
    return out


def _models(path):
    return vosk_tpu.Model(str(path)), vosk_tpu_torch.Model(str(path), device="cpu")


def _pcm(words, seed):
    wav = toydata.make_test_wav(words, seed=seed)
    return np.clip(wav, -32768, 32767).astype("<i2").tobytes()


def _split(data, step):
    return [data[i: i + step] for i in range(0, len(data), step)]


def _drive(rec, pieces, partial=True):
    rec.SetWords(True)
    out = []
    for piece in pieces:
        if rec.AcceptWaveform(piece):
            out.append(rec.Result())
        elif partial:
            out.append(rec.PartialResult())
    out.append(rec.FinalResult())
    return out


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


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_json(json.loads(g), json.loads(w))


def _both(path, pieces, grammar=None):
    jm, tm = _models(path)
    args = () if grammar is None else (grammar,)
    jrec = vosk_tpu.KaldiRecognizer(jm, 16000, *args)
    if grammar is not None:
        # the source builds the HCLr o G graph but decodes with the main
        # graph's decoder (ROADMAP C); point it at the grammar graph
        r = jrec._rec
        r.dec = jm._model.shared_decoder(graph=r.graph, cache_key=grammar)
        r._finisher = JFinisher(jm._model, r.dec)
        r._init_pipeline()
    trec = vosk_tpu_torch.KaldiRecognizer(tm, 16000, *args)
    want, got = _drive(jrec, pieces), _drive(trec, pieces)
    _assert_same(got, want)
    return json.loads(got[-1]), trec._rec


@pytest.mark.parametrize("layout", ["hclg", "split", "word_boundary"])
def test_kaldi_dir_matches_jax(dirs, layout):
    words = ["one", "five", "zero", "three"]
    res, rec = _both(dirs[layout], _split(_pcm(words, 123), 4000))
    assert res["text"] == " ".join(words)
    assert rec.am.has_ivector is False and rec.iv is None
    assert (rec.model.word_boundary is not None) == (layout == "word_boundary")
    assert (rec.model.hcl_fst is not None) == (layout == "split")


def test_ivector_dir_matches_jax(dirs):
    """Streamed in 6400-byte pieces so silence weighting runs mid-utterance."""
    words = ["three", "seven", "one"]
    res, rec = _both(dirs["ivector"], _split(_pcm(words, 300), 6400))
    assert res["text"]
    assert rec.iv is not None and rec.am.has_ivector
    assert int(rec._iv_state["centers_done"][0]) > 0
    iv = rec.iv.current(rec._iv_state)[0].numpy()
    assert np.all(np.isfinite(iv)) and np.any(iv != 0)
    assert rec._iv_frames_weighted > 0  # silence weighting engaged
    assert "ivector" in rec.get_metrics()["stages"]


def test_split_dir_grammar_matches_jax(dirs):
    res, _ = _both(dirs["split"], [_pcm(["one", "six"], 11)], grammar='["one six", "three"]')
    assert res["text"] == "one six"


def test_split_dir_grammar_decodes_with_the_grammar(dirs):
    """Audio of words outside the grammar: the result stays inside its
    vocabulary (the source's recognizer returns the main graph's words
    here; ROADMAP C)."""
    rec = vosk_tpu_torch.KaldiRecognizer(
        vosk_tpu_torch.Model(str(dirs["split"]), device="cpu"), 16000, '["three", "two"]')
    rec.AcceptWaveform(_pcm(["one", "six"], 11))
    text = json.loads(rec.FinalResult())["text"]
    assert text and set(text.split()) <= {"three", "two"}


def test_batch_model_matches_jax(dirs):
    datas = [_pcm(["six", "four"], 210), _pcm(["two", "seven", "zero"], 211)]
    texts = []
    for mod, kw in ((vosk_tpu, {}), (vosk_tpu_torch, {"device": "cpu"})):
        bm = mod.BatchModel(str(dirs["hclg"]), max_batch_size=2, **kw)
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
                out.append([(w["word"], w["start"], w["end"])
                            for w in json.loads(x).get("result", [])])
        texts.append(out)
    assert texts[1] == texts[0]
    assert [w for w, _, _ in texts[1][0]] == ["six", "four"]


def test_batch_model_refuses_an_ivector_model(dirs):
    with pytest.raises(ValueError, match="i-vector"):
        vosk_tpu_torch.BatchModel(str(dirs["ivector"]), max_batch_size=2, device="cpu")


def _add_rescoring(path, parts=("rescore", "rnnlm"), seed=0):
    """rescore/ (G.carpa + G.fst) and an LSTM rnnlm/ over the dir's words,
    written by the port's kaldidata writers at small dims."""
    from types import SimpleNamespace

    from vosk_tpu_torch.graph.fst import SymbolTable
    from vosk_tpu_torch.utils import kaldidata

    words = SymbolTable.read_text(path / "graph" / "words.txt")
    if "rescore" in parts:
        kaldidata.write_rescore_dir(SimpleNamespace(words=words), path, seed=seed,
                                    num_bigrams=30, num_trigrams=20)
    if "rnnlm" in parts:
        kaldidata.write_kaldi_rnnlm_dir(path / "rnnlm", words, seed=seed, embedding_dim=12,
                                        cell_dim=6, recurrent_dim=3, nonrecurrent_dim=3,
                                        num_features=40, num_frequent=6)


@pytest.mark.parametrize("change, error", [
    ("no_ivector", FileNotFoundError),
    ("rescore", None),
    ("rnnlm", None),
    ("pitch", None),
])
def test_unported_or_missing_parts_raise(dirs, tmp_path, change, error):
    """A missing ivector/ raises; rescore/, rnnlm/ and a pitch.conf load as
    the source loads them (they raised before the rescoring and pitch
    slices)."""
    broken = tmp_path / "broken"
    shutil.copytree(dirs["ivector"], broken)
    if change == "no_ivector":
        shutil.rmtree(broken / "ivector")
    elif change == "pitch":
        (broken / "conf" / "pitch.conf").write_text(
            "--sample-frequency=16000\n--min-f0=60\n--max-f0=380\n--nccf-ballast=5000\n")
    else:
        _add_rescoring(broken, (change,))
    if error is not None:
        with pytest.raises(error):
            vosk_tpu_torch.Model(str(broken), device="cpu")
        return
    t = vosk_tpu_torch.Model(str(broken), device="cpu")._model
    j = vosk_tpu.Model(str(broken))._model
    if change == "pitch":
        assert t.config.pitch_opts == j.config.pitch_opts == {
            "min_f0": 60.0, "max_f0": 380.0, "nccf_ballast": 5000.0}
        tx, jx = t.feature_extractor(), j.feature_extractor()
        assert tx.dim == jx.dim == tx.base_dim + 3
        assert dataclasses.asdict(tx.pitch.opts) == dataclasses.asdict(jx.pitch.opts)
        return
    if change == "rescore":
        np.testing.assert_array_equal(t.rescore_lm.lm_states, j.rescore_lm.lm_states)
        assert (t.g_fst.arcs, t.g_fst.final) == (j.g_fst.arcs, j.g_fst.final)
        assert t.rnnlm_rescorer is None
    else:
        tr, jr = t.rnnlm_rescorer, j.rnnlm_rescorer
        assert t.rescore_lm is None and t.g_fst is None
        for st in ((tr.lm.bos,), (tr.lm.bos, 3, 5), (tr.lm.bos, 1, 2, 9)):
            assert abs(tr.final_cost(st) - jr.final_cost(st)) <= 1e-4
            for w in (1, 4, 8):
                assert abs(tr.score(st, w)[0] - jr.score(st, w)[0]) <= 1e-4


def test_kaldi_dir_decodes_without_jax(dirs, tmp_path):
    """The i-vector dir with rescore/ and an LSTM rnnlm/ decodes and
    rescores with jax and vosk_tpu blocked."""
    path = tmp_path / "rescored"
    shutil.copytree(dirs["ivector"], path)
    _add_rescoring(path)
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.modules["vosk_tpu"] = None
import numpy as np
import vosk_tpu_torch
model = vosk_tpu_torch.Model({str(path)!r}, device="cpu")
rec = vosk_tpu_torch.KaldiRecognizer(model, 16000)
pcm = (np.random.default_rng(0).standard_normal(16000) * 500).astype("<i2").tobytes()
for i in range(0, len(pcm), 3200):
    rec.AcceptWaveform(pcm[i:i + 3200])
rec.AcceptWaveform(np.clip(np.sin(np.arange(8000) / 3.0) * 8000, -32768, 32767)
                   .astype("<i2").tobytes())
assert "text" in json.loads(rec.FinalResult())
fin = rec._rec._finisher
assert fin.rescoring and fin.rescore_stats["lattices"] > 0
assert model._model.rnnlm_rescorer.evaluated > 0
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
