"""x-vector speaker identification in PyTorch (reference SpkModel,
src/spk_model.cc, and the extraction at src/recognizer.cc:326-419: a TDNN
with statistics pooling, then mean subtraction, the transform and length
normalization).

Port of `vosk_tpu/models/xvector.py`.  `XvectorConfig`,
`init_xvector_params` and `export_kaldi_spk_model` are numpy copies of the
source's (tests/test_torch_copies.py holds them to it).  The native format
(`vosk_tpu_spk.json` + `spk.npz`) is the source's, so both packages load
one file; `SpkModel(cfg, params, mean, transform, device=...)` takes the
numpy parameters and keeps them as tensors on `device`.  A Kaldi speaker
dir (final.ext.raw, mean.vec, transform.mat) evaluates on the port's nnet3
evaluator with its weights on `device`.  The net's forward runs on the
device; the mean, transform and length normalization of the one [embed]
row run on the host, as in the source.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class XvectorConfig:
    feat_dim: int = 20
    hidden_dim: int = 64
    embed_dim: int = 32
    num_layers: int = 3
    context: int = 2  # splice +-context in first layer


def init_xvector_params(cfg: XvectorConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    p: Dict[str, np.ndarray] = {}
    in_dim = cfg.feat_dim * (2 * cfg.context + 1)
    for i in range(cfg.num_layers):
        p[f"l{i}_w"] = mat(in_dim if i == 0 else cfg.hidden_dim, cfg.hidden_dim)
        p[f"l{i}_b"] = np.zeros(cfg.hidden_dim, np.float32)
    p["post_w"] = mat(2 * cfg.hidden_dim, cfg.embed_dim)
    p["post_b"] = np.zeros(cfg.embed_dim, np.float32)
    return p


def xvector_forward(cfg: XvectorConfig, params: Dict[str, torch.Tensor],
                    feats: torch.Tensor) -> torch.Tensor:
    """feats: [T, D] -> embedding [embed_dim]: frame splice -> ReLU layers
    -> stats pooling (mean + population stddev) -> affine, the source's
    forward."""
    T = feats.shape[0]
    t = torch.arange(T, device=feats.device)
    x = torch.cat([feats[torch.clamp(t + o, 0, T - 1)]
                   for o in range(-cfg.context, cfg.context + 1)], dim=-1)
    for i in range(cfg.num_layers):
        x = torch.relu(torch.matmul(x, params[f"l{i}_w"]) + params[f"l{i}_b"])
    mean = x.mean(dim=0)
    std = torch.sqrt(torch.clamp(x.var(dim=0, unbiased=False), min=1e-10))
    return torch.matmul(torch.cat([mean, std]), params["post_w"]) + params["post_b"]


def _normalize(xvec: np.ndarray, mean: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Mean subtraction, transform, length normalization to sqrt(dim)
    (reference recognizer.cc:406-417)."""
    out = transform @ (xvec - mean)
    ratio = np.linalg.norm(out) / np.sqrt(out.shape[0])
    return out / ratio if ratio > 0 else out


class SpkModel:
    """Speaker model: x-vector net + global mean + transform (reference
    spk_model.cc:17-32 reads final.ext.raw, mean.vec, transform.mat), the
    net's parameters as tensors on `device`."""

    def __init__(self, cfg: XvectorConfig, params, mean, transform, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                       for k, v in params.items()}
        self.mean = np.asarray(mean, np.float32)
        self.transform = np.asarray(transform, np.float32)

    def extract(self, feats) -> np.ndarray:
        """feats: [T, D] speaker features (array or tensor) -> the whitened,
        length-normalized vector (numpy)."""
        x = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            xvec = xvector_forward(self.cfg, self.params, x).cpu().numpy()
        return _normalize(xvec, self.mean, self.transform)

    @classmethod
    def load(cls, path, device="cuda"):
        """A native speaker dir, or a Kaldi one (final.ext.raw)."""
        p = Path(path)
        cfg_file = p / "vosk_tpu_spk.json"
        if not cfg_file.exists():
            if (p / "final.ext.raw").exists():
                return load_kaldi_spk_model(p, device=device)
            raise FileNotFoundError(f"Folder '{path}' does not contain a speaker model")
        cfg = XvectorConfig(**json.loads(cfg_file.read_text()))
        z = np.load(p / "spk.npz")
        params = {k: z[k] for k in z.files if k not in ("mean", "transform")}
        return cls(cfg, params, z["mean"], z["transform"], device=device)

    def save(self, path) -> None:
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        (p / "vosk_tpu_spk.json").write_text(json.dumps(dataclasses.asdict(self.cfg)))
        np.savez(
            p / "spk.npz",
            **{k: v.cpu().numpy() for k, v in self.params.items()},
            mean=self.mean,
            transform=self.transform,
        )


class KaldiSpkModel:
    """Speaker model backed by a parsed nnet3 x-vector network (Kaldi
    final.ext.raw layout, reference spk_model.cc:17-32), its weights on
    `device`."""

    def __init__(self, net, mean, transform, feat_dim: int, device="cuda"):
        from ..io.nnet3 import net_tensors

        self.net = net
        self.device = torch.device(device)
        self.weights = net_tensors(net, self.device)
        self.mean = np.asarray(mean, np.float32)
        self.transform = np.asarray(transform, np.float32)
        self.cfg = XvectorConfig(feat_dim=feat_dim, embed_dim=len(mean))

    def extract(self, feats) -> np.ndarray:
        x = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            out = self.net.evaluate({"input": x[None]}, self.weights)  # [1, 1, embed]
        return _normalize(out[0, 0].cpu().numpy(), self.mean, self.transform)


def load_kaldi_spk_model(path, device="cuda") -> KaldiSpkModel:
    """Read a Kaldi speaker-model dir: final.ext.raw (raw nnet3), mean.vec,
    transform.mat."""
    from ..io.kaldiio import open_kaldi, read_kaldi_matrix, read_kaldi_vector
    from ..io.nnet3 import Nnet3

    p = Path(path)
    r, binary = open_kaldi(p / "final.ext.raw")
    if not binary:
        raise ValueError("text-mode final.ext.raw not supported")
    net = Nnet3.read(r)
    mean = read_kaldi_vector(p / "mean.vec")
    transform = read_kaldi_matrix(p / "transform.mat")
    return KaldiSpkModel(net, mean, transform, net.nodes["input"].dim, device=device)


def export_kaldi_spk_model(spk: SpkModel, out_dir) -> None:
    """Write a native SpkModel as a Kaldi-layout speaker dir (round-trip
    validation of the reading path)."""
    from ..io import nnet3 as n3
    from ..io.kaldiio import write_kaldi_object

    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    cfg = spk.cfg
    params = {k: v.cpu().numpy() for k, v in spk.params.items()}
    net = n3.Nnet3()
    lines = [f"input-node name=input dim={cfg.feat_dim}"]
    comps = {}
    offs = list(range(-cfg.context, cfg.context + 1))
    splice = ", ".join(
        f"Offset(input, {o})" if o else "input" for o in offs
    )
    prev = None
    for i in range(cfg.num_layers):
        inp = f"Append({splice})" if i == 0 else prev
        lines.append(f"component-node name=l{i}.affine component=l{i}.affine input={inp}")
        comps[f"l{i}.affine"] = n3.AffineComponent(params[f"l{i}_w"].T, params[f"l{i}_b"])
        lines.append(f"component-node name=l{i}.relu component=l{i}.relu input=l{i}.affine")
        comps[f"l{i}.relu"] = n3.NonlinComponent(cfg.hidden_dim, "RectifiedLinearComponent")
        prev = f"l{i}.relu"
    lines.append(f"component-node name=stats_ex component=stats_ex input={prev}")
    comps["stats_ex"] = n3.StatisticsExtractionComponent(cfg.hidden_dim, 1, 1, True)
    lines.append("component-node name=stats_pool component=stats_pool input=stats_ex")
    comps["stats_pool"] = n3.StatisticsPoolingComponent(
        1 + 2 * cfg.hidden_dim, 1, -1000, 1000, 0, True
    )
    lines.append("component-node name=post component=post input=stats_pool")
    comps["post"] = n3.AffineComponent(params["post_w"].T, params["post_b"])
    lines.append("output-node name=output input=post objective=linear")
    for line in lines:
        net._parse_config_line(line)
    net.components = comps
    net.component_order = list(comps)

    write_kaldi_object(p / "final.ext.raw", net.write)
    write_kaldi_object(p / "mean.vec", lambda w: w.write_vector(spk.mean))
    write_kaldi_object(p / "transform.mat", lambda w: w.write_matrix(spk.transform))
    (p / "mfcc.conf").write_text(
        f"--num-ceps={cfg.feat_dim}\n--num-mel-bins={cfg.feat_dim + 3}\n"
        "--use-energy=false\n"
    )


MIN_SPK_FEATS = 50  # reference recognizer.cc:354


def extract_xvector_for_recognizer(rec) -> Tuple[Optional[list], Optional[int]]:
    """The speaker vector of a Recognizer's current utterance audio from
    its non-silence frames (reference GetSpkVector, recognizer.cc:356-419):
    MFCC at the speaker model's width on its device, the frames whose
    decoded pdf (whole-utterance best path: frozen prefix + retained
    window) is not silence, sliding-window CMN (300 frames, centered),
    then the model.  Returns (vector list, num_frames), or (None, None)
    with fewer than MIN_SPK_FEATS such frames."""
    from ..ops.features import (
        FeatureExtractor,
        FrameOptions,
        MelOptions,
        MfccOptions,
        sliding_window_cmn,
    )

    if not rec._spk_feats:
        return None, None
    spk = rec.spk_model
    wav = np.concatenate(rec._spk_feats)
    ex = FeatureExtractor(
        MfccOptions(
            frame_opts=FrameOptions(dither=0.0, samp_freq=rec.model_rate),
            mel_opts=MelOptions(num_bins=spk.cfg.feat_dim + 3),
            num_ceps=spk.cfg.feat_dim,
            use_energy=False,
        ),
        device=spk.device,
    )
    feats = ex.extract(wav[None])[0]  # [T, D] 10 ms frames

    # non-silence selection from the decoder's best-path alignment (output
    # frames are subsample x 10 ms)
    _, _, pdfs = rec._full_traceback(use_final=False)
    sil = set(int(x) for x in rec.model.silence_pdfs)
    ss = rec.am.subsample
    keep = []
    for i in range(feats.shape[0]):
        j = min(i // ss, len(pdfs) - 1) if pdfs else -1
        if j >= 0 and pdfs[j] not in sil:
            keep.append(i)
    if len(keep) < MIN_SPK_FEATS:
        return None, None
    sel = feats[torch.as_tensor(keep, device=feats.device)]
    sel = sliding_window_cmn(sel, window=300, center=True)
    vec = spk.extract(sel)
    return [float(x) for x in vec], len(keep)
