"""Speaker identification in vosk_tpu_torch against vosk_tpu, on the CPU.

sliding_window_cmn / global_cmvn and xvector_forward on the same seeded
inputs and parameters (within 1e-5: f32, summation order only); a small
x-vector net with the VoxCeleb recipe's node graph (relu-batchnorm
layers, the statistics pair read through Round) written once by the
port's nnet3 writer and read by both packages (evaluate within 1e-5); the
native and Kaldi speaker-dir round trips; and the speaker branch of
KaldiRecognizer on the toy model (the native speaker model of
tests/test_speaker.py): the same text and spk_frames, and `spk` within
1e-4, compared as parsed floats (each side rounds its x-vector to 6
decimals).
"""
import io
import json

import numpy as np
import pytest
import torch

import vosk_tpu
import vosk_tpu_torch
from vosk_tpu.io import nnet3 as j3
from vosk_tpu.io.kaldiio import BinaryReader as JReader, BinaryWriter as JWriter
from vosk_tpu.models import xvector as jx
from vosk_tpu.ops import features as JF
from vosk_tpu.utils import toydata
from vosk_tpu_torch.io import nnet3 as t3
from vosk_tpu_torch.io.kaldiio import BinaryReader, BinaryWriter
from vosk_tpu_torch.models import xvector as tx
from vosk_tpu_torch.ops import features as TF
from vosk_tpu_torch.runtime import native_lattice
from vosk_tpu_torch.utils import kaldidata

SPK_CFG = dict(feat_dim=20, hidden_dim=32, embed_dim=16, num_layers=2)


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages finish lattices through core/libvosk_tpu_core.so."""
    return native_lattice.build_library()


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("norm_vars", [False, True])
def test_sliding_window_cmn_matches_jax(center, norm_vars):
    rng = np.random.default_rng(int(center) * 2 + int(norm_vars))
    feats = (rng.standard_normal((2, 420, 6)) * 3 + 1).astype(np.float32)
    for x in (feats[0], feats):  # [T, D] and [B, T, D]
        want = np.asarray(JF.sliding_window_cmn(x, window=100, center=center,
                                                norm_vars=norm_vars))
        got = TF.sliding_window_cmn(torch.from_numpy(x), window=100, center=center,
                                    norm_vars=norm_vars).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm_vars", [False, True])
def test_global_cmvn_matches_jax(norm_vars):
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((30, 4)).astype(np.float32) * 2
    frames = rng.standard_normal((200, 4)) * 1.5 + 0.5
    stats = np.zeros((2, 5))
    stats[0, :4], stats[0, 4], stats[1, :4] = frames.sum(0), 200, (frames ** 2).sum(0)
    want = np.asarray(JF.global_cmvn(feats, stats, norm_vars))
    got = TF.global_cmvn(torch.from_numpy(feats), stats, norm_vars).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_xvector_forward_matches_jax():
    cfg = tx.XvectorConfig(**SPK_CFG)
    params = tx.init_xvector_params(cfg, seed=3)
    for k, v in jx.init_xvector_params(jx.XvectorConfig(**SPK_CFG), seed=3).items():
        np.testing.assert_array_equal(params[k], v)
    feats = np.random.default_rng(4).standard_normal((90, 20)).astype(np.float32)
    want = np.asarray(jx.xvector_forward(jx.XvectorConfig(**SPK_CFG), params, feats))
    got = tx.xvector_forward(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                             torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _recipe_net(seed=0):
    """The recipe's node graph at small widths, as written by the port."""
    net = kaldidata.xvector_net(np.random.default_rng(seed), feat_dim=8,
                                layer_dims=(16, 16, 16, 16, 24), embed_dim=12)
    buf = io.BytesIO()
    net.write(BinaryWriter(buf))
    return buf.getvalue()


def test_recipe_xvector_net_matches_jax():
    raw = _recipe_net()
    tnet = t3.Nnet3.read(BinaryReader(io.BytesIO(raw)))
    jnet = j3.Nnet3.read(JReader(io.BytesIO(raw)))
    assert tnet.node_order == jnet.node_order
    assert {type(c).__name__ for c in tnet.components.values()} >= {
        "BatchNormComponent", "StatisticsExtractionComponent", "StatisticsPoolingComponent"}
    assert tnet.nodes["tdnn6.affine"].descriptor.op == "round"
    buf = io.BytesIO()
    tnet.write(BinaryWriter(buf))
    assert buf.getvalue() == raw
    rng = np.random.default_rng(1)
    w = t3.net_tensors(tnet, "cpu")
    for T in (1, 37, 120):
        x = rng.standard_normal((T, 8)).astype(np.float32)
        want = np.asarray(jnet.evaluate({"input": x}))
        got = tnet.evaluate({"input": torch.from_numpy(x)[None]}, w).numpy()
        assert got.shape == (1, 1, 12) and want.shape == (1, 12)
        np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-5)
    # the batch of sequences pools each sequence on its own
    xs = rng.standard_normal((3, 50, 8)).astype(np.float32)
    got = tnet.evaluate({"input": torch.from_numpy(xs)}, w).numpy()
    for b in range(3):
        np.testing.assert_allclose(got[b], np.asarray(jnet.evaluate({"input": xs[b]})),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("num_log_count, stddevs", [(0, True), (2, True), (1, False)])
def test_statistics_components_match_jax(num_log_count, stddevs):
    din = 5
    x = np.random.default_rng(num_log_count).standard_normal((2, 17, din)).astype(np.float32)
    for var in (True, False):
        if not var and stddevs:
            continue
        jex = j3.StatisticsExtractionComponent(din, 1, 1, var)
        dim = 1 + din * (2 if var else 1)
        jpool = j3.StatisticsPoolingComponent(dim, 1, -5, 20, num_log_count, stddevs, 1e-4)
        comps = []
        for jc in (jex, jpool):
            buf = io.BytesIO()
            jc.write(JWriter(buf))
            raw = buf.getvalue()
            comps.append((t3.read_component(BinaryReader(io.BytesIO(raw))),
                          j3.read_component(JReader(io.BytesIO(raw)))))
        (tex, jex), (tpool, jpool) = comps
        assert vars(tpool) == vars(jpool) and vars(tex) == vars(jex)
        got = tpool.forward(tex.forward(torch.from_numpy(x), {}), {}).numpy()
        assert got.shape == (2, 1, tpool.output_dim())
        for b in range(2):
            want = np.asarray(jpool.forward(jex.forward(x[b])))
            np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def spk_dirs(tmp_path_factory):
    """The toy speaker model of tests/test_speaker.py saved by the source,
    its Kaldi export by the port, and a recipe-shaped Kaldi dir."""
    root = tmp_path_factory.mktemp("spk")
    cfg = jx.XvectorConfig(**SPK_CFG)
    rng = np.random.default_rng(1)
    jx.SpkModel(cfg, jx.init_xvector_params(cfg, seed=0),
                mean=rng.standard_normal(16).astype(np.float32) * 0.1,
                transform=np.eye(16, dtype=np.float32)).save(root / "native")
    tx.export_kaldi_spk_model(tx.SpkModel.load(root / "native", device="cpu"), root / "kaldi")
    kaldidata.write_kaldi_xvector_dir(root / "recipe", seed=2, feat_dim=20,
                                      layer_dims=(24, 24, 24, 24, 40), embed_dim=16, lda_dim=8)
    return root


def test_spk_model_dirs_round_trip(spk_dirs, tmp_path):
    feats = np.random.default_rng(7).standard_normal((80, 20)).astype(np.float32)
    native = tx.SpkModel.load(spk_dirs / "native", device="cpu")
    want = jx.SpkModel.load(spk_dirs / "native").extract(feats)
    np.testing.assert_allclose(native.extract(feats), want, rtol=0, atol=1e-4)
    native.save(tmp_path / "again")
    assert (tmp_path / "again" / "vosk_tpu_spk.json").read_text() == (
        spk_dirs / "native" / "vosk_tpu_spk.json").read_text()
    back = jx.SpkModel.load(tmp_path / "again")
    np.testing.assert_allclose(back.extract(feats), want, rtol=0, atol=1e-5)
    for name in ("kaldi", "recipe"):
        t = tx.SpkModel.load(spk_dirs / name, device="cpu")
        j = jx.SpkModel.load(spk_dirs / name)
        assert isinstance(t, tx.KaldiSpkModel) and t.cfg.feat_dim == j.cfg.feat_dim == 20
        got = t.extract(feats)
        np.testing.assert_allclose(got, j.extract(feats), rtol=0, atol=1e-4)
        assert abs(np.linalg.norm(got) - np.sqrt(len(got))) < 1e-3
    np.testing.assert_allclose(tx.SpkModel.load(spk_dirs / "kaldi", device="cpu").extract(feats),
                               want, rtol=0, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        tx.SpkModel.load(tmp_path / "nothing", device="cpu")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("toy") / "model")
    toydata.build_toy_model(path, train_steps=400)
    return vosk_tpu.Model(path), vosk_tpu_torch.Model(path, device="cpu")


def _pcm(words, seed):
    wav = toydata.make_test_wav(words, seed=seed)
    return np.clip(wav, -32768, 32767).astype("<i2").tobytes()


def _final(mod, model, spk, pcm, late=False, step=6400):
    rec = mod.KaldiRecognizer(model, 16000, spk) if spk is not None and not late else \
        mod.KaldiRecognizer(model, 16000)
    if late:
        rec.SetSpkModel(spk)
    for i in range(0, len(pcm), step):
        rec.AcceptWaveform(pcm[i:i + step])
    return json.loads(rec.FinalResult())


def _same_result(got, want):
    assert got.keys() == want.keys()
    assert got["text"] == want["text"]
    if "spk" in want:
        assert got["spk_frames"] == want["spk_frames"]
        np.testing.assert_allclose(got["spk"], want["spk"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name, late", [("native", False), ("native", True),
                                        ("kaldi", False), ("recipe", False)])
def test_recognizer_spk_matches_jax(models, spk_dirs, name, late):
    jm, tm = models
    pcm = _pcm(["one", "two", "three", "four"], 60)
    want = _final(vosk_tpu, jm, vosk_tpu.SpkModel(str(spk_dirs / name)), pcm, late)
    got = _final(vosk_tpu_torch, tm, vosk_tpu_torch.SpkModel(str(spk_dirs / name),
                                                             device="cpu"), pcm, late)
    _same_result(got, want)
    assert len(got["spk"]) == (8 if name == "recipe" else 16) and got["spk_frames"] >= 50


def test_spk_model_after_running_raises_and_short_audio_has_none(models, spk_dirs):
    jm, tm = models
    spk = vosk_tpu_torch.SpkModel(str(spk_dirs / "native"), device="cpu")
    rec = vosk_tpu_torch.KaldiRecognizer(tm, 16000)
    rec.AcceptWaveform(_pcm(["five"], 3)[:6400])
    with pytest.raises(RuntimeError):
        rec.SetSpkModel(spk)
    short = _pcm(["one"], 63)[:4000]
    got = _final(vosk_tpu_torch, tm, spk, short)
    want = _final(vosk_tpu, jm, vosk_tpu.SpkModel(str(spk_dirs / "native")), short)
    assert "spk" not in got and got == want


def test_spk_after_final_result_is_per_utterance(models, spk_dirs):
    """FinalResult recycles the pipeline and forgets the speaker audio, as
    the source does: a second utterance's x-vector is its own."""
    jm, tm = models
    outs = []
    for mod, m, kw in ((vosk_tpu, jm, {}), (vosk_tpu_torch, tm, {"device": "cpu"})):
        rec = mod.KaldiRecognizer(m, 16000, mod.SpkModel(str(spk_dirs / "native"), **kw))
        res = []
        for words, seed in ((["five", "six", "seven", "zero"], 61), (["two", "one"], 64)):
            rec.AcceptWaveform(_pcm(words, seed))
            res.append(json.loads(rec.FinalResult()))
        outs.append(res)
    for g, w in zip(outs[1], outs[0]):
        _same_result(g, w)
