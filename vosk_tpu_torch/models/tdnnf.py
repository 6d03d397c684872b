"""TDNN-F acoustic model as a PyTorch module.

Port of `vosk_tpu/models/tdnnf.py`: `TdnnfConfig` and `init_params` are
seed-identical numpy copies, so both packages build the same model from a
seed; `TdnnfModel` is the forward pass as an `nn.Module` (relu-batchnorm
input layer, a stack of factorized TDNN-F layers with bottleneck + bypass,
prefinal linear, chain output without log-softmax, frame subsampling).
Every layer is a matmul over spliced frames, as in the source.

compute_dtype="bfloat16": the source multiplies bf16 inputs with f32
outputs (`preferred_element_type=float32`).  Here the inputs are rounded to
bf16 and the product is taken in f32, which keeps the f32 output on every
device (a bf16 x bf16 product is exact in f32; only the summation order
differs).  The weights are rounded once at construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .streaming import StreamingAm


@dataclasses.dataclass
class TdnnfConfig:
    feat_dim: int = 40
    ivector_dim: int = 0
    hidden_dim: int = 512
    bottleneck_dim: int = 96
    prefinal_dim: int = 192
    num_pdfs: int = 128
    # per-TDNN-F-layer time strides (0 = no splicing in that layer)
    time_strides: tuple = (1, 1, 1, 0, 3, 3, 3, 3, 3, 3, 3)
    subsample: int = 3
    bypass_scale: float = 0.75
    compute_dtype: str = "float32"  # or "bfloat16"

    @property
    def left_context(self) -> int:
        return 1 + sum(self.time_strides)

    @property
    def right_context(self) -> int:
        return 1 + sum(self.time_strides)


def init_params(cfg: TdnnfConfig, seed: int = 0) -> dict:
    """Random (inference-normalized) parameters, seed-identical to
    `vosk_tpu.models.tdnnf.init_params`."""
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    p: dict = {}
    in_dim = (cfg.feat_dim + cfg.ivector_dim) * 3  # splice (-1,0,1)
    p["tdnn1_w"] = mat(in_dim, cfg.hidden_dim)
    p["tdnn1_b"] = np.zeros(cfg.hidden_dim, np.float32)
    p["tdnn1_scale"] = np.ones(cfg.hidden_dim, np.float32)
    p["tdnn1_offset"] = np.zeros(cfg.hidden_dim, np.float32)
    for i, s in enumerate(cfg.time_strides):
        taps = 1 if s == 0 else 2
        p[f"tdnnf{i}_lin"] = mat(cfg.hidden_dim * taps, cfg.bottleneck_dim)
        p[f"tdnnf{i}_aff_w"] = mat(cfg.bottleneck_dim * taps, cfg.hidden_dim)
        p[f"tdnnf{i}_aff_b"] = np.zeros(cfg.hidden_dim, np.float32)
        p[f"tdnnf{i}_scale"] = np.ones(cfg.hidden_dim, np.float32)
        p[f"tdnnf{i}_offset"] = np.zeros(cfg.hidden_dim, np.float32)
    p["prefinal_l"] = mat(cfg.hidden_dim, cfg.prefinal_dim)
    p["prefinal_w"] = mat(cfg.prefinal_dim, cfg.hidden_dim)
    p["prefinal_b"] = np.zeros(cfg.hidden_dim, np.float32)
    p["prefinal_scale"] = np.ones(cfg.hidden_dim, np.float32)
    p["prefinal_offset"] = np.zeros(cfg.hidden_dim, np.float32)
    p["prefinal_l2"] = mat(cfg.hidden_dim, cfg.prefinal_dim)
    p["output_w"] = mat(cfg.prefinal_dim, cfg.num_pdfs)
    p["output_b"] = np.zeros(cfg.num_pdfs, np.float32)
    return p


def _splice(x: torch.Tensor, offsets) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D*len(offsets)] with edge clamping (callers
    pre-pad with edge-frame copies, so emitted frames never depend on it)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    return torch.cat([x[:, torch.clamp(t + off, 0, T - 1)] for off in offsets], dim=-1)


_MATMUL_KEYS = ("_w", "_lin", "_l", "_l2")


class TdnnfModel(nn.Module, StreamingAm):
    """TDNN-F forward over parameters held as (frozen) module parameters;
    streaming state = carried feature context (StreamingAm)."""

    def __init__(self, cfg: TdnnfConfig, params: dict, device="cuda"):
        super().__init__()
        if cfg.ivector_dim:
            raise NotImplementedError(
                "native TDNN-F models with an i-vector input are not ported; "
                "Kaldi nnet3 models with one load through models/am.py Nnet3Am"
            )
        self.cfg = cfg
        self.bf16 = cfg.compute_dtype == "bfloat16"
        tensors = {}
        for k, v in params.items():
            t = torch.tensor(np.asarray(v, np.float32))
            if self.bf16 and k.endswith(_MATMUL_KEYS):
                t = t.to(torch.bfloat16).to(torch.float32)
            tensors[k] = nn.Parameter(t, requires_grad=False)
        self.params = nn.ParameterDict(tensors).to(device)

    @property
    def device(self) -> torch.device:
        return self.params["tdnn1_w"].device

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.bf16:
            x = x.to(torch.bfloat16).to(torch.float32)
        return torch.matmul(x, w)

    def forward(self, feats: torch.Tensor, ivector=None) -> torch.Tensor:
        """feats [B, T, feat_dim] -> pseudo-loglikes [B, ceil(T/ss), pdfs]
        (`ivector` is always None: the model has no i-vector input)."""
        cfg, p, mm = self.cfg, self.params, self._mm
        x = _splice(feats, (-1, 0, 1))
        x = mm(x, p["tdnn1_w"]) + p["tdnn1_b"]
        x = torch.relu(x) * p["tdnn1_scale"] + p["tdnn1_offset"]

        for i, s in enumerate(cfg.time_strides):
            y = x if s == 0 else _splice(x, (-s, 0))
            b = mm(y, p[f"tdnnf{i}_lin"])
            y2 = b if s == 0 else _splice(b, (0, s))
            y2 = mm(y2, p[f"tdnnf{i}_aff_w"]) + p[f"tdnnf{i}_aff_b"]
            y2 = torch.relu(y2) * p[f"tdnnf{i}_scale"] + p[f"tdnnf{i}_offset"]
            x = cfg.bypass_scale * x + y2

        x = mm(x, p["prefinal_l"])
        x = mm(x, p["prefinal_w"]) + p["prefinal_b"]
        x = torch.relu(x) * p["prefinal_scale"] + p["prefinal_offset"]
        x = mm(x, p["prefinal_l2"])
        out = mm(x, p["output_w"]) + p["output_b"]
        # chain output: raw pseudo-loglikes, no log-softmax (run_tdnn.sh:120)
        return out[:, :: cfg.subsample]

    @property
    def feat_dim(self) -> int:
        return self.cfg.feat_dim

    @property
    def subsample(self) -> int:
        return self.cfg.subsample

    @property
    def left_context(self) -> int:
        return self.cfg.left_context

    @property
    def right_context(self) -> int:
        return self.cfg.right_context


def tdnnf_params_from_jax(params: dict, cfg: TdnnfConfig, device="cuda") -> TdnnfModel:
    """The port's module holding the JAX package's TDNN-F parameters
    (`vosk_tpu.models.tdnnf.TdnnfModel.params`, as numpy arrays), so both
    packages compute the same function.  The config is not stored in the
    parameters (time strides cannot be read off shapes), so it is passed."""
    return TdnnfModel(cfg, {k: np.asarray(v) for k, v in params.items()}, device)
