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
differs).  A serving model rounds its weights once at construction; a
trainable one (`trainable=True`, the trainers' f32 master weights) rounds
both operands inside each product through `bf16_matmul`, whose backward
rounds each gradient to bf16 as `jax.grad` of the source's product does.
Both run the one forward, `tdnnf_forward`.  With `mesh` (parallel/mesh.py)
a model axis of more than one rank makes it tensor parallel: each rank
keeps its shard of the parameters (`mesh.am_param_sharding`, the source's
rule) and the forward runs `TensorParallelOps`.  On the card the streaming
chunk replays a captured CUDA graph (models/streaming.py `process_chunk`),
except where the model is tensor parallel or trainable.
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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _Bf16Matmul(torch.autograd.Function):
    """x @ w over bf16-rounded operands with an f32 result, as the source's
    `jnp.matmul(x.astype(bf16), w.astype(bf16), preferred_element_type=f32)`.
    Its gradients are what `jax.grad` gives there: the f32 cotangent (not
    rounded) times the other rounded operand, summed in f32, then rounded to
    bf16 once (the transposed product takes the bf16 operand's type)."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = _bf16(x), _bf16(w)
        ctx.save_for_backward(xb, wb)
        return torch.matmul(xb, wb)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        dx = _bf16(torch.matmul(g, wb.t()))
        dw = _bf16(xb.reshape(-1, xb.shape[-1]).t() @ g.reshape(-1, g.shape[-1]))
        return dx, dw


bf16_matmul = _Bf16Matmul.apply


class _DenseOps:
    """The forward's layer operations over whole tensors."""

    def __init__(self, p, mm):
        self.p, self.mm = p, mm

    def input(self, x):
        return x

    def splice(self, x, offsets):
        return _splice(x, offsets)

    def affine(self, x, w, b=None):
        y = self.mm(x, self.p[w])
        return y if b is None else y + self.p[b]

    def unit(self, x, prefix):
        return torch.relu(x) * self.p[f"{prefix}_scale"] + self.p[f"{prefix}_offset"]

    def bypass(self, scale, x, y):
        return scale * x + y

    def output(self, x):
        return x


class _Part:
    """An activation of the tensor-parallel forward: whole on every rank, or
    this rank's block of its last axis (`local`); `whole` caches the
    gathered tensor."""

    __slots__ = ("t", "local", "whole")

    def __init__(self, t, local):
        self.t, self.local, self.whole = t, local, None if local else t


class TensorParallelOps:
    """The forward's layer operations over parameters sharded across the
    mesh's `model` axis by `mesh.am_param_sharding` (each rank holds only its
    shard `p[name]`; `dims[name]` is the sharded axis or None), with the
    collectives written out where the source leaves them to XLA's
    partitioner:
      * a product with a column-sharded weight (the rule's usual case) is
        taken locally on the whole input and leaves this rank's block of
        the output columns;
      * a product with a row-sharded weight takes the matching block of the
        input's last axis, then a SUM all-reduce;
      * per-unit vectors (bias, scale, offset) apply to the block they
        hold, so a layer's output stays a block until something needs it
        whole: a splice (time indexing over every unit), the next product,
        or the output, where one all_gather of the last axis assembles it.
    The bypass adds blocks.  bf16 rounding stays in `mm`: operands rounded,
    f32 sums.  Explicit collectives rather than DTensor: the splice's time
    indexing and the rounding stay where the forward puts them, and whether
    an activation is whole or a block is visible at each step, where DTensor
    would choose its redistributions by its own rules."""

    def __init__(self, p, dims, mm, mesh):
        from ..parallel import mesh as pmesh

        self.p, self.dims, self.mm, self.mesh = p, dims, mm, mesh
        self.n, self.r = pmesh.axis_size(mesh, "model"), mesh.get_local_rank("model")
        self._gather = lambda t: pmesh.all_gather_cat(mesh, "model", t, -1)
        self._sum = lambda t: pmesh.all_reduce_sum(mesh, "model", t)

    def _whole(self, v):
        if v.whole is None:
            v.whole = self._gather(v.t)
        return v.whole

    def _block(self, v):
        return v.t if v.local else v.t.tensor_split(self.n, -1)[self.r]

    def _vec(self, name, v, op):
        vec, dim = self.p[name], self.dims[name]
        if dim is None and not v.local:
            return _Part(op(v.t, vec), False)
        return _Part(op(self._block(v), vec if dim == 0 else vec.tensor_split(self.n)[self.r]),
                     True)

    def input(self, x):
        return _Part(x, False)

    def splice(self, v, offsets):
        return _Part(_splice(self._whole(v), offsets), False)

    def affine(self, v, w, b=None):
        W, dim = self.p[w], self.dims[w]
        if dim == 1:
            y = _Part(self.mm(self._whole(v), W), True)
        elif dim == 0:
            y = _Part(self._sum(self.mm(self._block(v), W)), False)
        else:
            y = _Part(self.mm(self._whole(v), W), False)
        return y if b is None else self._vec(b, y, torch.add)

    def unit(self, v, prefix):
        y = self._vec(f"{prefix}_scale", _Part(torch.relu(v.t), v.local), torch.mul)
        return self._vec(f"{prefix}_offset", y, torch.add)

    def bypass(self, scale, x, y):
        if not (x.local or y.local):
            return _Part(scale * x.t + y.t, False)
        return _Part(scale * self._block(x) + self._block(y), True)

    def output(self, v):
        return self._whole(v)


def tdnnf_forward(cfg: TdnnfConfig, p, feats: torch.Tensor, mm, ops=None) -> torch.Tensor:
    """The TDNN-F forward over parameters `p` (a name -> tensor mapping):
    feats [B, T, feat_dim] -> pseudo-loglikes [B, ceil(T/ss), pdfs], every
    product through `mm(x, w)`.  ops: the layer operations, whole tensors
    by default (`TensorParallelOps` for a model sharded over a mesh)."""
    o = ops or _DenseOps(p, mm)
    x = o.affine(o.splice(o.input(feats), (-1, 0, 1)), "tdnn1_w", "tdnn1_b")
    x = o.unit(x, "tdnn1")

    for i, s in enumerate(cfg.time_strides):
        y = x if s == 0 else o.splice(x, (-s, 0))
        b = o.affine(y, f"tdnnf{i}_lin")
        y2 = b if s == 0 else o.splice(b, (0, s))
        y2 = o.unit(o.affine(y2, f"tdnnf{i}_aff_w", f"tdnnf{i}_aff_b"), f"tdnnf{i}")
        x = o.bypass(cfg.bypass_scale, x, y2)

    x = o.affine(x, "prefinal_l")
    x = o.unit(o.affine(x, "prefinal_w", "prefinal_b"), "prefinal")
    x = o.affine(x, "prefinal_l2")
    out = o.output(o.affine(x, "output_w", "output_b"))
    # chain output: raw pseudo-loglikes, no log-softmax (run_tdnn.sh:120)
    return out[:, :: cfg.subsample]


class TdnnfModel(StreamingAm, nn.Module):
    """TDNN-F forward over parameters held as module parameters: frozen and
    pre-rounded for serving, or f32 master weights with gradients when
    `trainable`; streaming state = carried feature context (StreamingAm)."""

    def __init__(self, cfg: TdnnfConfig, params: dict, device="cuda", trainable=False,
                 mesh=None):
        super().__init__()
        self._own_programs()
        if cfg.ivector_dim:
            raise NotImplementedError(
                "native TDNN-F models with an i-vector input are not ported; "
                "Kaldi nnet3 models with one load through models/am.py Nnet3Am"
            )
        self.cfg = cfg
        self.bf16 = cfg.compute_dtype == "bfloat16"
        self.trainable = trainable
        # tensor parallel over the mesh's model axis: each rank keeps only
        # its shard of every parameter the rule shards (parallel/mesh.py)
        from ..parallel import mesh as pmesh

        self.mesh = mesh if mesh is not None and pmesh.axis_size(mesh, "model") > 1 else None
        self.shard_dims = {}
        if self.mesh is not None:
            if trainable:
                raise ValueError("a tensor-parallel TDNN-F serves; it does not train")
            params = {k: np.asarray(v, np.float32) for k, v in params.items()}
            self.shard_dims = {k: pmesh.am_param_sharding(self.mesh, k, v.shape)
                               for k, v in params.items()}
            params = pmesh.shard_am_params(self.mesh, params)
        tensors = {}
        for k, v in params.items():
            t = torch.tensor(np.asarray(v, np.float32))
            if self.bf16 and not trainable and k.endswith(_MATMUL_KEYS):
                t = _bf16(t)
            tensors[k] = nn.Parameter(t, requires_grad=trainable)
        self.params = nn.ParameterDict(tensors).to(device)

    @property
    def device(self) -> torch.device:
        return self.params["tdnn1_w"].device

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if not self.bf16:
            return torch.matmul(x, w)
        if self.trainable:
            return bf16_matmul(x, w)
        return torch.matmul(_bf16(x), w)

    def forward(self, feats: torch.Tensor, ivector=None) -> torch.Tensor:
        """feats [B, T, feat_dim] -> pseudo-loglikes [B, ceil(T/ss), pdfs]
        (`ivector` is always None: the model has no i-vector input)."""
        ops = None if self.mesh is None else TensorParallelOps(
            self.params, self.shard_dims, self._mm, self.mesh)
        return tdnnf_forward(self.cfg, self.params, feats, self._mm, ops)

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
