"""nnet3 network reader + PyTorch evaluator.

Port of `vosk_tpu/io/nnet3.py`.  The parser, the descriptor grammar, the
writer, `AmNnetSimple` and `read_final_mdl` are numpy copies of the source
(tests/test_torch_copies.py holds them to it); the component forwards are
torch:

  - network graph: config lines (input-node / component-node / output-node
    / dim-range-node) with the descriptor grammar Append/Offset/Sum/Scale/
    Const/ReplaceIndex/Round/IfDefined/Failover
  - components with a torch forward (what a Kaldi TDNN-F chain AM, a
    TDNN-LSTM RNNLM and an x-vector net use): [NaturalGradient|Fixed]
    AffineComponent, LinearComponent, TdnnComponent, RectifiedLinear,
    Sigmoid, Tanh, (Log)Softmax, BatchNorm (test mode), NoOp, Dropout/
    GeneralDropout/BackpropTruncation (identity at test time),
    PerElementScale/Offset, LstmNonlinearity (the fused LSTM gates),
    StatisticsExtraction/StatisticsPooling (x-vector stats layers, pooled
    over each whole sequence)

Weights stay numpy in the parsed components; `net_tensors` carries them to
a device once (models/am.py `Nnet3Am` and io/kaldi_rnnlm.py do so at
construction) and `Nnet3.evaluate` takes them with a batch of sequences
[B, T, D].  Acyclic graphs evaluate whole sequences per node; cyclic
(recurrent) graphs take the source's time-stepped unroll, per (node, t) on
[B, dim] rows.  Unknown components raise with their type name.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from .kaldiio import BinaryReader, BinaryWriter, KaldiReadError, open_kaldi

# ---------------------------------------------------------------- payloads


def _peek(r: BinaryReader) -> int:
    return r.peek_byte()


def read_any_payload(r: BinaryReader):
    """Read a payload of unknown type following a tag: basic type, bool,
    vector, or matrix."""
    b = _peek(r)
    if b in (1, 2, 4, 8):
        size = r.read_bytes(1)[0]
        data = r.read_bytes(size)
        if size == 4:
            # ambiguous int/float; return raw
            return ("raw4", data)
        return ("raw", data)
    if b in (ord("T"), ord("F")):
        # bool or FV/FM token — look further
        tok = r.read_token()
        if tok in ("FV", "DV"):
            n = r.read_basic_int()
            width = 4 if tok == "FV" else 8
            return ("vector", np.frombuffer(r.read_bytes(width * n), dtype=f"<f{width}"))
        if tok in ("FM", "DM"):
            rows = r.read_basic_int()
            cols = r.read_basic_int()
            width = 4 if tok == "FM" else 8
            return (
                "matrix",
                np.frombuffer(r.read_bytes(width * rows * cols), dtype=f"<f{width}").reshape(rows, cols),
            )
        if tok == "T":
            return ("bool", True)
        if tok == "F":
            return ("bool", False)
        raise KaldiReadError(f"unexpected token in payload: {tok}")
    if b == ord("C"):
        return ("matrix", r.read_matrix())
    # token-valued payload (e.g. nested tag) — caller handles
    return ("none", None)


def skip_until(r: BinaryReader, close_tag: str, handlers: Dict[str, object]) -> Dict[str, object]:
    """Token-driven component body parse: dispatch known tags to handlers
    ('int','float','bool','vector','matrix','intvec'), skip unknown tags
    generically, stop at close_tag."""
    out: Dict[str, object] = {}
    while True:
        tok = r.read_token()
        if tok == close_tag:
            return out
        kind = handlers.get(tok)
        if kind == "int":
            out[tok] = r.read_basic_int()
        elif kind == "float":
            out[tok] = r.read_basic_float()
        elif kind == "bool":
            out[tok] = r.read_bool()
        elif kind == "vector":
            out[tok] = r.read_vector()
        elif kind == "matrix":
            out[tok] = r.read_matrix()
        elif kind == "intvec":
            out[tok] = r.read_int_vector()
        else:
            if not (tok.startswith("<") and tok.endswith(">")):
                raise KaldiReadError(f"unexpected token {tok!r} before {close_tag}")
            read_any_payload(r)


# -------------------------------------------------------------- components


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def _clamped_time(T: int, off: int, device) -> torch.Tensor:
    """Frame indices t + off clamped to [0, T) (edge copy at the window
    ends, as the source's `np.clip` index)."""
    return torch.clamp(torch.arange(T, device=device) + off, 0, T - 1)


class Component:
    """A parsed component: numpy parameters, `tensors(device)` to carry
    them to a device, and `forward(x, w)` over x [B, T, in] with those
    tensors."""

    type_name = "Component"

    def output_dim(self) -> int:
        raise NotImplementedError

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        return {}

    def forward(self, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def write_body(self, w: BinaryWriter) -> None:
        raise NotImplementedError

    def write(self, w: BinaryWriter) -> None:
        w.write_token(f"<{self.type_name}>")
        self.write_body(w)
        w.write_token(f"</{self.type_name}>")


class AffineComponent(Component):
    type_name = "NaturalGradientAffineComponent"

    def __init__(self, linear: np.ndarray, bias: np.ndarray, type_name=None):
        self.linear = np.asarray(linear, np.float32)  # [out, in]
        self.bias = np.asarray(bias, np.float32)
        if type_name:
            self.type_name = type_name

    def output_dim(self) -> int:
        return self.linear.shape[0]

    def tensors(self, device):
        return {"w": _t(self.linear.T, device), "b": _t(self.bias, device)}

    def forward(self, x, w):
        return torch.matmul(x, w["w"]) + w["b"]

    @classmethod
    def read_body(cls, r: BinaryReader, type_name: str) -> "AffineComponent":
        got = skip_until(
            r,
            f"</{type_name}>",
            {"<LinearParams>": "matrix", "<BiasParams>": "vector"},
        )
        return cls(got["<LinearParams>"], got["<BiasParams>"], type_name)

    def write_body(self, w: BinaryWriter) -> None:
        w.write_token("<LinearParams>")
        w.write_matrix(self.linear)
        w.write_token("<BiasParams>")
        w.write_vector(self.bias)


class LinearComponent(Component):
    type_name = "LinearComponent"

    def __init__(self, params: np.ndarray):
        self.params = np.asarray(params, np.float32)  # [out, in]

    def output_dim(self) -> int:
        return self.params.shape[0]

    def tensors(self, device):
        return {"w": _t(self.params.T, device)}

    def forward(self, x, w):
        return torch.matmul(x, w["w"])

    @classmethod
    def read_body(cls, r: BinaryReader, type_name: str) -> "LinearComponent":
        got = skip_until(r, f"</{type_name}>", {"<Params>": "matrix"})
        return cls(got["<Params>"])

    def write_body(self, w: BinaryWriter) -> None:
        w.write_token("<Params>")
        w.write_matrix(self.params)


class TdnnComponent(Component):
    """Factorized-TDNN building block: internal time offsets + linear (+bias).
    (nnet3/nnet-tdnn-component; generated by tdnnf-layer xconfig.)"""

    type_name = "TdnnComponent"

    def __init__(self, time_offsets, linear, bias=None):
        self.time_offsets = list(time_offsets)
        self.linear = np.asarray(linear, np.float32)  # [out, in*len(offsets)]
        self.bias = None if bias is None or len(bias) == 0 else np.asarray(bias, np.float32)

    def output_dim(self) -> int:
        return self.linear.shape[0]

    @property
    def input_dim(self) -> int:
        return self.linear.shape[1] // len(self.time_offsets)

    def tensors(self, device):
        out = {"w": _t(self.linear.T, device)}
        if self.bias is not None:
            out["b"] = _t(self.bias, device)
        return out

    def forward_time(self, x, w):
        """x: [B, T, in] -> [B, T, out] with internal splicing
        (edge-clamped per sequence)."""
        T = x.shape[1]
        spliced = torch.cat(
            [x[:, _clamped_time(T, off, x.device)] for off in self.time_offsets], dim=-1
        )
        out = torch.matmul(spliced, w["w"])
        if self.bias is not None:
            out = out + w["b"]
        return out

    forward = forward_time

    @classmethod
    def read_body(cls, r: BinaryReader, type_name: str) -> "TdnnComponent":
        got = skip_until(
            r,
            f"</{type_name}>",
            {
                "<TimeOffsets>": "intvec",
                "<LinearParams>": "matrix",
                "<BiasParams>": "vector",
            },
        )
        return cls(
            got["<TimeOffsets>"],
            got["<LinearParams>"],
            got.get("<BiasParams>"),
        )

    def write_body(self, w: BinaryWriter) -> None:
        w.write_token("<TimeOffsets>")
        w.write_int_vector(self.time_offsets)
        w.write_token("<LinearParams>")
        w.write_matrix(self.linear)
        if self.bias is not None:
            w.write_token("<BiasParams>")
            w.write_vector(self.bias)


_NONLIN_FN = {
    "RectifiedLinearComponent": torch.relu,
    "SigmoidComponent": torch.sigmoid,
    "TanhComponent": torch.tanh,
    "LogSoftmaxComponent": lambda x: torch.log_softmax(x, dim=-1),
    "SoftmaxComponent": lambda x: torch.softmax(x, dim=-1),
}


class NonlinComponent(Component):
    def __init__(self, dim: int, type_name: str):
        self.dim = dim
        self.type_name = type_name

    def output_dim(self) -> int:
        return self.dim

    def forward(self, x, w):
        fn = _NONLIN_FN.get(self.type_name)
        if fn is None:
            raise KaldiReadError(f"unknown nonlinearity {self.type_name}")
        return fn(x)

    @classmethod
    def read_body(cls, r: BinaryReader, type_name: str) -> "NonlinComponent":
        got = skip_until(r, f"</{type_name}>", {"<Dim>": "int"})
        return cls(int(got.get("<Dim>", 0)), type_name)

    def write_body(self, w: BinaryWriter) -> None:
        w.write_token("<Dim>")
        w.write_basic_int(self.dim)


class BatchNormComponent(Component):
    type_name = "BatchNormComponent"

    def __init__(self, dim, epsilon, target_rms, stats_mean, stats_var):
        self.dim = dim
        self.epsilon = epsilon
        self.target_rms = target_rms
        self.stats_mean = np.asarray(stats_mean, np.float32)
        self.stats_var = np.asarray(stats_var, np.float32)

    def output_dim(self) -> int:
        return self.dim

    def tensors(self, device):
        # test mode: the source folds the statistics into scale and offset
        # in numpy float32, and so does the port
        scale = self.target_rms / np.sqrt(self.stats_var + self.epsilon)
        offset = -self.stats_mean * scale
        return {"scale": _t(scale, device), "offset": _t(offset, device)}

    def forward(self, x, w):
        return x * w["scale"] + w["offset"]

    @classmethod
    def read_body(cls, r: BinaryReader, type_name: str) -> "BatchNormComponent":
        got = skip_until(
            r,
            f"</{type_name}>",
            {
                "<Dim>": "int",
                "<Epsilon>": "float",
                "<TargetRms>": "float",
                "<StatsMean>": "vector",
                "<StatsVar>": "vector",
            },
        )
        dim = int(got.get("<Dim>", len(got.get("<StatsMean>", []))))
        return cls(
            dim,
            float(got.get("<Epsilon>", 1e-3)),
            float(got.get("<TargetRms>", 1.0)),
            got.get("<StatsMean>", np.zeros(dim, np.float32)),
            got.get("<StatsVar>", np.ones(dim, np.float32)),
        )

    def write_body(self, w: BinaryWriter) -> None:
        w.write_token("<Dim>")
        w.write_basic_int(self.dim)
        w.write_token("<Epsilon>")
        w.write_basic_float(self.epsilon)
        w.write_token("<TargetRms>")
        w.write_basic_float(self.target_rms)
        w.write_token("<StatsMean>")
        w.write_vector(self.stats_mean)
        w.write_token("<StatsVar>")
        w.write_vector(self.stats_var)


class IdentityComponent(Component):
    """NoOp / Dropout-in-test-mode and friends."""

    def __init__(self, dim: int, type_name: str):
        self.dim = dim
        self.type_name = type_name

    def output_dim(self) -> int:
        return self.dim

    def forward(self, x, w):
        return x

    @classmethod
    def read_body(cls, r: BinaryReader, type_name: str) -> "IdentityComponent":
        got = skip_until(r, f"</{type_name}>", {"<Dim>": "int"})
        return cls(int(got.get("<Dim>", 0)), type_name)

    def write_body(self, w: BinaryWriter) -> None:
        w.write_token("<Dim>")
        w.write_basic_int(self.dim)


class LstmNonlinearityComponent(Component):
    """Kaldi LstmNonlinearityComponent (nnet-combined-component.cc): the
    fused LSTM gate nonlinearity with diagonal peephole weights.

    Input [*, 5C] = (i_part, f_part, c_part, o_part, c_prev); params [3, C]
    = (w_ic, w_fc, w_oc); output [*, 2C] = (c_t, m_t):

      i = sigmoid(i_part + w_ic * c_prev)
      f = sigmoid(f_part + w_fc * c_prev)
      c = f * c_prev + i * tanh(c_part)
      o = sigmoid(o_part + w_oc * c)
      m = o * tanh(c)
    """

    type_name = "LstmNonlinearityComponent"

    def __init__(self, params: np.ndarray):
        assert params.shape[0] == 3
        self.params = params.astype(np.float32)
        self.cell_dim = params.shape[1]

    def output_dim(self) -> int:
        return 2 * self.cell_dim

    def tensors(self, device):
        return {"w": _t(self.params, device)}

    def forward(self, x, w):
        C = self.cell_dim
        w_ic, w_fc, w_oc = w["w"]
        i_p, f_p, c_p, o_p, c_prev = (x[..., k * C: (k + 1) * C] for k in range(5))
        i = torch.sigmoid(i_p + w_ic * c_prev)
        f = torch.sigmoid(f_p + w_fc * c_prev)
        c = f * c_prev + i * torch.tanh(c_p)
        o = torch.sigmoid(o_p + w_oc * c)
        m = o * torch.tanh(c)
        return torch.cat([c, m], dim=-1)

    @classmethod
    def read_body(cls, r: BinaryReader, type_name: str):
        got = skip_until(r, f"</{type_name}>", {"<Params>": "matrix"})
        params = got.get("<Params>")
        if params is None:
            raise KaldiReadError("LstmNonlinearityComponent without <Params>")
        return cls(np.asarray(params))

    def write_body(self, w: BinaryWriter) -> None:
        w.write_token("<Params>")
        w.write_matrix(self.params)


class PerElementScaleComponent(Component):
    type_name = "NaturalGradientPerElementScaleComponent"

    def __init__(self, params, type_name=None):
        self.params = np.asarray(params, np.float32)
        if type_name:
            self.type_name = type_name

    def output_dim(self) -> int:
        return len(self.params)

    def tensors(self, device):
        return {"scale": _t(self.params, device)}

    def forward(self, x, w):
        return x * w["scale"]

    @classmethod
    def read_body(cls, r, type_name):
        got = skip_until(r, f"</{type_name}>", {"<Params>": "vector"})
        return cls(got["<Params>"], type_name)

    def write_body(self, w):
        w.write_token("<Params>")
        w.write_vector(self.params)


class PerElementOffsetComponent(Component):
    type_name = "PerElementOffsetComponent"

    def __init__(self, offsets):
        self.offsets = np.asarray(offsets, np.float32)

    def output_dim(self) -> int:
        return len(self.offsets)

    def tensors(self, device):
        return {"offset": _t(self.offsets, device)}

    def forward(self, x, w):
        return x + w["offset"]

    @classmethod
    def read_body(cls, r, type_name):
        got = skip_until(r, f"</{type_name}>", {"<Offsets>": "vector"})
        return cls(got["<Offsets>"])

    def write_body(self, w):
        w.write_token("<Offsets>")
        w.write_vector(self.offsets)


class StatisticsExtractionComponent(Component):
    """x-vector stats rows: [count 1, x, x*x] per frame (the source's
    forward, on [B, T, in])."""

    type_name = "StatisticsExtractionComponent"

    def __init__(self, input_dim, input_period, output_period, include_variance):
        self.input_dim = input_dim
        self.input_period = input_period
        self.output_period = output_period
        self.include_variance = include_variance

    def output_dim(self) -> int:
        return 1 + self.input_dim * (2 if self.include_variance else 1)

    def forward(self, x, w):
        count = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        if self.include_variance:
            return torch.cat([count, x, x * x], dim=-1)
        return torch.cat([count, x], dim=-1)

    @classmethod
    def read_body(cls, r, type_name):
        got = skip_until(
            r,
            f"</{type_name}>",
            {
                "<InputDim>": "int",
                "<InputPeriod>": "int",
                "<OutputPeriod>": "int",
                "<IncludeVarinance>": "bool",  # sic — Kaldi's historical typo
                "<IncludeVariance>": "bool",
            },
        )
        return cls(
            int(got["<InputDim>"]),
            int(got.get("<InputPeriod>", 1)),
            int(got.get("<OutputPeriod>", 1)),
            bool(got.get("<IncludeVarinance>", got.get("<IncludeVariance>", True))),
        )

    def write_body(self, w):
        w.write_token("<InputDim>")
        w.write_basic_int(self.input_dim)
        w.write_token("<InputPeriod>")
        w.write_basic_int(self.input_period)
        w.write_token("<OutputPeriod>")
        w.write_basic_int(self.output_period)
        w.write_token("<IncludeVarinance>")
        w.write_bool(self.include_variance)


class StatisticsPoolingComponent(Component):
    """Pools stats rows over each whole sequence, as the source's x-vector
    path does: [B, T, 1+d(+d)] -> [B, 1, out] = (num_log_count copies of
    log count, mean, stddev floored at `variance_floor`), the count floored
    at 1.  Downstream descriptors then see one row per sequence, as the
    source's [T_out, out] for one sequence."""

    type_name = "StatisticsPoolingComponent"

    def __init__(self, input_dim, input_period, left_context, right_context,
                 num_log_count, output_stddevs, variance_floor=1e-10):
        self.input_dim = input_dim
        self.input_period = input_period
        self.left_context = left_context
        self.right_context = right_context
        self.num_log_count = num_log_count
        self.output_stddevs = output_stddevs
        self.variance_floor = variance_floor

    def output_dim(self) -> int:
        return self.num_log_count + (self.input_dim - 1)

    def forward(self, x, w):
        summed = x.sum(dim=1, keepdim=True)  # [B, 1, in]
        count = torch.clamp(summed[..., :1], min=1.0)
        rest = summed[..., 1:] / count
        d = (x.shape[-1] - 1) // 2
        out = []
        if self.num_log_count:
            out.append(torch.log(count).expand(-1, -1, self.num_log_count))
        if self.output_stddevs:
            mean = rest[..., :d]
            var = torch.clamp(rest[..., d:] - mean * mean, min=self.variance_floor)
            out.extend([mean, torch.sqrt(var)])
        else:
            out.append(rest)
        return torch.cat(out, dim=-1)

    @classmethod
    def read_body(cls, r, type_name):
        got = skip_until(
            r,
            f"</{type_name}>",
            {
                "<InputDim>": "int",
                "<InputPeriod>": "int",
                "<LeftContext>": "int",
                "<RightContext>": "int",
                "<NumLogCountFeatures>": "int",
                "<OutputStddevs>": "bool",
                "<VarianceFloor>": "float",
            },
        )
        return cls(
            int(got["<InputDim>"]),
            int(got.get("<InputPeriod>", 1)),
            int(got.get("<LeftContext>", -1000)),
            int(got.get("<RightContext>", 1000)),
            int(got.get("<NumLogCountFeatures>", 0)),
            bool(got.get("<OutputStddevs>", True)),
            float(got.get("<VarianceFloor>", 1e-10)),
        )

    def write_body(self, w):
        w.write_token("<InputDim>")
        w.write_basic_int(self.input_dim)
        w.write_token("<InputPeriod>")
        w.write_basic_int(self.input_period)
        w.write_token("<LeftContext>")
        w.write_basic_int(self.left_context)
        w.write_token("<RightContext>")
        w.write_basic_int(self.right_context)
        w.write_token("<NumLogCountFeatures>")
        w.write_basic_int(self.num_log_count)
        w.write_token("<OutputStddevs>")
        w.write_bool(self.output_stddevs)
        w.write_token("<VarianceFloor>")
        w.write_basic_float(self.variance_floor)


_NONLIN = set(_NONLIN_FN)
_IDENTITY = {
    "NoOpComponent",
    "DropoutComponent",
    "GeneralDropoutComponent",
    # inference-time identity: clips gradients only during training
    "BackpropTruncationComponent",
}


def read_component(r: BinaryReader) -> Component:
    tag = r.read_token()
    if not (tag.startswith("<") and tag.endswith(">")):
        raise KaldiReadError(f"expected component tag, got {tag!r}")
    name = tag[1:-1]
    if name in ("NaturalGradientAffineComponent", "AffineComponent", "FixedAffineComponent"):
        return AffineComponent.read_body(r, name)
    if name == "LinearComponent":
        return LinearComponent.read_body(r, name)
    if name == "TdnnComponent":
        return TdnnComponent.read_body(r, name)
    if name in _NONLIN:
        return NonlinComponent.read_body(r, name)
    if name == "BatchNormComponent":
        return BatchNormComponent.read_body(r, name)
    if name in _IDENTITY:
        return IdentityComponent.read_body(r, name)
    if name in ("NaturalGradientPerElementScaleComponent", "PerElementScaleComponent"):
        return PerElementScaleComponent.read_body(r, name)
    if name == "PerElementOffsetComponent":
        return PerElementOffsetComponent.read_body(r, name)
    if name == "StatisticsExtractionComponent":
        return StatisticsExtractionComponent.read_body(r, name)
    if name == "StatisticsPoolingComponent":
        return StatisticsPoolingComponent.read_body(r, name)
    if name == "LstmNonlinearityComponent":
        return LstmNonlinearityComponent.read_body(r, name)
    raise KaldiReadError(f"unsupported nnet3 component type: {name}")


def net_tensors(net: "Nnet3", device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every component's parameters as float32 tensors on `device`, keyed
    by component name: the one place weights cross from the parsed numpy
    network to the device."""
    return {name: comp.tensors(device) for name, comp in net.components.items()}


# ------------------------------------------------------------- descriptors


@dataclasses.dataclass
class Desc:
    op: str  # node|append|offset|sum|scale|const|replace_index|round|ifdefined
    args: tuple


def parse_descriptor(text: str) -> Desc:
    text = text.strip()
    m = re.match(r"^(\w[\w.\-]*)\((.*)\)$", text, re.S)
    if not m:
        return Desc("node", (text,))
    op, inner = m.group(1), m.group(2)

    def split_args(s: str) -> List[str]:
        parts, depth, cur = [], 0, []
        for ch in s:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        if cur:
            parts.append("".join(cur))
        return [p.strip() for p in parts]

    args = split_args(inner)
    if op == "Append":
        return Desc("append", tuple(parse_descriptor(a) for a in args))
    if op == "Offset":
        return Desc("offset", (parse_descriptor(args[0]), int(args[1])))
    if op == "Sum":
        return Desc("sum", tuple(parse_descriptor(a) for a in args))
    if op == "Scale":
        return Desc("scale", (float(args[0]), parse_descriptor(args[1])))
    if op == "Const":
        return Desc("const", (float(args[0]), int(args[1])))
    if op == "ReplaceIndex":
        return Desc("replace_index", (parse_descriptor(args[0]), args[1], int(args[2])))
    if op == "Round":
        return Desc("round", (parse_descriptor(args[0]), int(args[1])))
    if op == "IfDefined":
        return Desc("ifdefined", (parse_descriptor(args[0]),))
    if op == "Failover":
        return Desc("failover", (parse_descriptor(args[0]), parse_descriptor(args[1])))
    raise KaldiReadError(f"unsupported descriptor op {op}")


# ------------------------------------------------------------------ graph


@dataclasses.dataclass
class NetNode:
    kind: str  # input|component|output|dim_range
    name: str
    dim: int = 0
    component: Optional[str] = None
    descriptor: Optional[Desc] = None
    dim_offset: int = 0


class Nnet3:
    def __init__(self):
        self.nodes: Dict[str, NetNode] = {}
        self.node_order: List[str] = []
        self.components: Dict[str, Component] = {}
        self.component_order: List[str] = []

    # ---------------------------------------------------------- file read

    @classmethod
    def read(cls, r: BinaryReader) -> "Nnet3":
        net = cls()
        r.expect_token("<Nnet3>")
        # config lines are newline-terminated text even in binary files
        lines = []
        buf = bytearray()
        while True:
            c = r.read_bytes(1)
            if c == b"\n":
                line = buf.decode("utf-8").strip()
                buf = bytearray()
                if not line:
                    if lines:
                        break
                    continue
                lines.append(line)
            else:
                buf += c
        for line in lines:
            net._parse_config_line(line)
        r.expect_token("<NumComponents>")
        n = r.read_basic_int()
        for _ in range(n):
            name = r.read_token()
            comp = read_component(r)
            net.components[name] = comp
            net.component_order.append(name)
        r.expect_token("</Nnet3>")
        return net

    def write(self, w: BinaryWriter) -> None:
        w.write_token("<Nnet3>")
        w.s.write(b"\n")
        for name in self.node_order:
            nd = self.nodes[name]
            if nd.kind == "input":
                w.s.write(f"input-node name={name} dim={nd.dim}\n".encode())
            elif nd.kind == "component":
                w.s.write(
                    f"component-node name={name} component={nd.component} "
                    f"input={_desc_to_str(nd.descriptor)}\n".encode()
                )
            elif nd.kind == "dim_range":
                w.s.write(
                    f"dim-range-node name={name} "
                    f"input-node={_desc_to_str(nd.descriptor)} "
                    f"dim-offset={nd.dim_offset} dim={nd.dim}\n".encode()
                )
            elif nd.kind == "output":
                w.s.write(
                    f"output-node name={name} input={_desc_to_str(nd.descriptor)} "
                    f"objective=linear\n".encode()
                )
        w.s.write(b"\n")
        w.write_token("<NumComponents>")
        w.write_basic_int(len(self.component_order))
        for name in self.component_order:
            w.write_token(name)
            self.components[name].write(w)
        w.write_token("</Nnet3>")

    def _parse_config_line(self, line: str) -> None:
        parts = line.split(None, 1)
        if not parts:
            return
        kind = parts[0]
        kv: Dict[str, str] = {}
        # split key=value pairs; values may contain nested parens with spaces
        rest = parts[1] if len(parts) > 1 else ""
        i = 0
        while i < len(rest):
            m = re.match(r"\s*([\w-]+)=", rest[i:])
            if not m:
                break
            key = m.group(1)
            j = i + m.end()
            depth = 0
            k = j
            while k < len(rest):
                ch = rest[k]
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                elif ch == " " and depth == 0:
                    break
                k += 1
            kv[key] = rest[j:k]
            i = k
        name = kv.get("name", "")
        if kind == "input-node":
            self.nodes[name] = NetNode("input", name, dim=int(kv["dim"]))
            self.node_order.append(name)
        elif kind == "component-node":
            self.nodes[name] = NetNode(
                "component",
                name,
                component=kv["component"],
                descriptor=parse_descriptor(kv["input"]),
            )
            self.node_order.append(name)
        elif kind == "output-node":
            self.nodes[name] = NetNode(
                "output", name, descriptor=parse_descriptor(kv["input"])
            )
            self.node_order.append(name)
        elif kind == "dim-range-node":
            self.nodes[name] = NetNode(
                "dim_range",
                name,
                dim=int(kv["dim"]),
                dim_offset=int(kv["dim-offset"]),
                descriptor=parse_descriptor(kv["input-node"]),
            )
            self.node_order.append(name)
        # component lines ("component name=... type=...") appear in config
        # dumps but not in compiled model files; ignore others

    # ----------------------------------------------------------- evaluate

    def has_recurrence(self) -> bool:
        """True when the node graph is cyclic (LSTM/GRU-style nets whose
        recurrence is expressed as IfDefined(Offset(x, -d)) back-edges)."""
        if getattr(self, "_recurrent", None) is not None:
            return self._recurrent

        def refs(d: Desc):
            if d.op == "node":
                yield d.args[0]
            else:
                for a in d.args:
                    if isinstance(a, Desc):
                        yield from refs(a)

        color: Dict[str, int] = {}

        def cyclic(name: str) -> bool:
            c = color.get(name, 0)
            if c == 1:
                return True
            if c == 2:
                return False
            color[name] = 1
            nd = self.nodes.get(name)
            if nd is not None and nd.descriptor is not None:
                for dep in refs(nd.descriptor):
                    if cyclic(dep):
                        return True
            color[name] = 2
            return False

        self._recurrent = any(cyclic(n) for n in list(self.nodes))
        return self._recurrent

    def check_acyclic(self) -> None:
        """Raise for a cyclic graph where only a feedforward net serves: a
        streaming AM (the source's context walk never ends on one)."""
        if self.has_recurrence():
            raise NotImplementedError(
                "a recurrent (cyclic) nnet3 graph cannot serve as the streaming "
                "acoustic model; Nnet3.evaluate unrolls it per frame")

    def evaluate(self, inputs: Dict[str, torch.Tensor],
                 weights: Dict[str, Dict[str, torch.Tensor]],
                 output: str = "output") -> torch.Tensor:
        """inputs: node name -> [B, T, dim] (an i-vector as [B, 1, dim]);
        weights: `net_tensors(self, device)`.  Returns [B, T, out_dim].

        The source's per-sequence evaluation ([T, dim], vmapped over
        channels) on a batch: time indexing is edge-clamped per sequence
        (looped-decodable padding semantics; callers pad the input context
        as with models/tdnnf).  Cyclic graphs (LSTM recurrence) take the
        time-stepped path."""
        if self.has_recurrence():
            return self._evaluate_recurrent(inputs, weights, output)
        cache: Dict[str, torch.Tensor] = {}
        T = max(int(v.shape[1]) for v in inputs.values())
        B = next(iter(inputs.values())).shape[0]
        dev = next(iter(inputs.values())).device

        def eval_node(name: str):
            if name in cache:
                return cache[name]
            nd = self.nodes[name]
            if nd.kind == "input":
                v = inputs[name]
                if v.shape[1] == 1 and T > 1:
                    v = v.expand(-1, T, -1)
                y = v
            elif nd.kind == "component":
                y = self.components[nd.component].forward(
                    eval_desc(nd.descriptor), weights[nd.component])
            elif nd.kind == "dim_range":
                y = eval_desc(nd.descriptor)[..., nd.dim_offset: nd.dim_offset + nd.dim]
            elif nd.kind == "output":
                y = eval_desc(nd.descriptor)
            else:
                raise KaldiReadError(f"cannot evaluate node kind {nd.kind}")
            cache[name] = y
            return y

        def eval_desc(d: Desc):
            if d.op == "node":
                return eval_node(d.args[0])
            if d.op == "append":
                return torch.cat([eval_desc(a) for a in d.args], dim=-1)
            if d.op == "offset":
                x = eval_desc(d.args[0])
                return x[:, _clamped_time(x.shape[1], d.args[1], x.device)]
            if d.op == "sum":
                out = eval_desc(d.args[0])
                for a in d.args[1:]:
                    out = out + eval_desc(a)
                return out
            if d.op == "scale":
                return d.args[0] * eval_desc(d.args[1])
            if d.op == "const":
                return torch.full((B, T, d.args[1]), d.args[0], dtype=torch.float32,
                                  device=dev)
            if d.op == "replace_index":
                # ReplaceIndex(x, t, 0): broadcast frame 0 across time — the
                # i-vector pattern (run_tdnn.sh:105)
                x = eval_desc(d.args[0])
                if d.args[1] == "t":
                    row = x[:, min(max(d.args[2], 0), x.shape[1] - 1)]
                    return row[:, None, :].expand(-1, T, -1)
                return x
            if d.op == "round":
                x = eval_desc(d.args[0])
                mod = d.args[1]
                idx = torch.div(torch.arange(x.shape[1], device=x.device), mod,
                                rounding_mode="floor") * mod
                return x[:, torch.clamp(idx, 0, x.shape[1] - 1)]
            if d.op in ("ifdefined", "failover"):
                return eval_desc(d.args[0])
            raise KaldiReadError(f"cannot evaluate descriptor {d.op}")

        return eval_node(output)

    def _evaluate_recurrent(self, inputs: Dict[str, torch.Tensor],
                            weights: Dict[str, Dict[str, torch.Tensor]],
                            output: str = "output") -> torch.Tensor:
        """Time-stepped evaluation for cyclic (recurrent) graphs, the
        source's backprop-free unroll on [B, dim] rows: each (node, t) is
        memoized; a back-edge IfDefined(Offset(x, -d)) reads (x, t-d), which
        is zeros for t < 0 (Kaldi's IfDefined semantics at the sequence
        start); offsets past the end clamp to the last frame
        (looped-decodable padding).  The reference evaluates recurrent
        RNNLMs incrementally the same way (rnnlm-compute-state.cc)."""
        T = max(int(v.shape[1]) for v in inputs.values())
        B = next(iter(inputs.values())).shape[0]
        dev = next(iter(inputs.values())).device
        vals: Dict[tuple, torch.Tensor] = {}
        stack: set = set()

        def node_dim(name: str) -> int:
            nd = self.nodes[name]
            if nd.kind == "input":
                return int(inputs[name].shape[2])
            if nd.kind == "component":
                return self.components[nd.component].output_dim()
            return nd.dim

        def eval_node(name: str, t: int) -> torch.Tensor:
            t = min(t, T - 1)
            key = (name, t)
            if key in vals:
                return vals[key]
            if key in stack:
                raise KaldiReadError(
                    f"recurrent cycle through {name} at t={t} has no "
                    "negative-offset back-edge")
            stack.add(key)
            try:
                nd = self.nodes[name]
                if nd.kind == "input":
                    v = inputs[name]
                    row = v[:, min(t, v.shape[1] - 1)]
                elif nd.kind == "component":
                    x = eval_desc(nd.descriptor, t)
                    row = self.components[nd.component].forward(
                        x[:, None, :], weights[nd.component])[:, 0]
                elif nd.kind == "dim_range":
                    x = eval_desc(nd.descriptor, t)
                    row = x[:, nd.dim_offset: nd.dim_offset + nd.dim]
                elif nd.kind == "output":
                    row = eval_desc(nd.descriptor, t)
                else:
                    raise KaldiReadError(f"cannot evaluate node kind {nd.kind}")
            finally:
                stack.discard(key)
            vals[key] = row
            return row

        def desc_dim(d: Desc) -> int:
            if d.op == "node":
                return node_dim(d.args[0])
            if d.op == "append":
                return sum(desc_dim(a) for a in d.args)
            if d.op in ("offset", "round", "sum", "replace_index", "ifdefined",
                        "failover"):
                return desc_dim(d.args[0])
            if d.op == "scale":
                return desc_dim(d.args[1])
            if d.op == "const":
                return d.args[1]
            raise KaldiReadError(f"bad desc {d.op}")

        def eval_desc(d: Desc, t: int, defined_only: bool = False):
            if d.op == "node":
                return eval_node(d.args[0], t)
            if d.op == "append":
                return torch.cat([eval_desc(a, t) for a in d.args], dim=-1)
            if d.op == "offset":
                t2 = t + d.args[1]
                if t2 < 0:
                    if defined_only:
                        return None
                    t2 = 0  # plain Offset clamps; IfDefined handled below
                return eval_desc(d.args[0], t2, defined_only)
            if d.op == "sum":
                out = eval_desc(d.args[0], t)
                for a in d.args[1:]:
                    out = out + eval_desc(a, t)
                return out
            if d.op == "scale":
                return d.args[0] * eval_desc(d.args[1], t)
            if d.op == "const":
                return torch.full((B, d.args[1]), d.args[0], dtype=torch.float32,
                                  device=dev)
            if d.op == "replace_index":
                if d.args[1] == "t":
                    return eval_desc(d.args[0], int(d.args[2]))
                return eval_desc(d.args[0], t)
            if d.op == "round":
                mod = d.args[1]
                return eval_desc(d.args[0], (t // mod) * mod)
            if d.op == "ifdefined":
                # zeros when the (time-shifted) dependency is undefined
                v = eval_desc(d.args[0], t, defined_only=True)
                if v is None:
                    return torch.zeros((B, desc_dim(d.args[0])), dtype=torch.float32,
                                       device=dev)
                return v
            if d.op == "failover":
                v = eval_desc(d.args[0], t, defined_only=True)
                if v is None:
                    return eval_desc(d.args[1], t)
                return v
            raise KaldiReadError(f"cannot evaluate descriptor {d.op}")

        return torch.stack([eval_node(output, t) for t in range(T)], dim=1)


def _desc_to_str(d: Desc) -> str:
    if d.op == "node":
        return d.args[0]
    if d.op == "append":
        return "Append(" + ", ".join(_desc_to_str(a) for a in d.args) + ")"
    if d.op == "offset":
        return f"Offset({_desc_to_str(d.args[0])}, {d.args[1]})"
    if d.op == "sum":
        return "Sum(" + ", ".join(_desc_to_str(a) for a in d.args) + ")"
    if d.op == "scale":
        return f"Scale({d.args[0]}, {_desc_to_str(d.args[1])})"
    if d.op == "const":
        return f"Const({d.args[0]}, {d.args[1]})"
    if d.op == "replace_index":
        return f"ReplaceIndex({_desc_to_str(d.args[0])}, {d.args[1]}, {d.args[2]})"
    if d.op == "round":
        return f"Round({_desc_to_str(d.args[0])}, {d.args[1]})"
    if d.op == "ifdefined":
        return f"IfDefined({_desc_to_str(d.args[0])})"
    if d.op == "failover":
        return f"Failover({_desc_to_str(d.args[0])}, {_desc_to_str(d.args[1])})"
    raise KaldiReadError(f"bad desc {d.op}")


# ----------------------------------------------------------- AmNnetSimple


@dataclasses.dataclass
class AmNnetSimple:
    nnet: Nnet3
    priors: np.ndarray
    left_context: int = 0
    right_context: int = 0

    @classmethod
    def read(cls, r: BinaryReader) -> "AmNnetSimple":
        nnet = Nnet3.read(r)
        tok = r.read_token()
        left = right = 0
        priors = np.zeros(0, np.float32)
        while tok != "</AmNnetSimple>":
            if tok == "<LeftContext>":
                left = r.read_basic_int()
            elif tok == "<RightContext>":
                right = r.read_basic_int()
            elif tok == "<Priors>":
                priors = r.read_vector()
            else:
                read_any_payload(r)
            try:
                tok = r.read_token()
            except KaldiReadError:
                break
        return cls(nnet, priors, left, right)

    def write(self, w: BinaryWriter) -> None:
        self.nnet.write(w)
        w.write_token("<LeftContext>")
        w.write_basic_int(self.left_context)
        w.write_token("<RightContext>")
        w.write_basic_int(self.right_context)
        w.write_token("<Priors>")
        w.write_vector(self.priors)
        w.write_token("</AmNnetSimple>")


def read_final_mdl(path):
    """final.mdl = TransitionModel + AmNnetSimple (reference
    model.cc:233-243)."""
    from .kaldi_models import TransitionModel

    r, binary = open_kaldi(path)
    if not binary:
        raise KaldiReadError("text-mode final.mdl not supported yet")
    tm = TransitionModel.read(r)
    am = AmNnetSimple.read(r)
    return tm, am
