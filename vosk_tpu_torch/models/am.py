"""Acoustic model wrapper for loaded nnet3 networks, in PyTorch.

Port of `vosk_tpu/models/am.py`: `Nnet3Am` adapts an io.nnet3 network
(read from a Kaldi final.mdl) to the streaming AM interface the runtime
drives — the reference's `DecodableNnetSimpleLoopedInfo` role
(model.cc:245): chunked evaluation with context carry, frame subsampling,
an optional i-vector input, optional prior subtraction (non-chain models
divide by priors; chain models have empty priors).

The network's weights are carried to the device once, at construction
(`io.nnet3.net_tensors`); the forward evaluates a batch of windows
[B, W, D] directly where the source vmaps a per-sequence evaluation.  On
the card the streaming chunk, i-vector included, replays a captured CUDA
graph per chunk shape (models/streaming.py `process_chunk`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..io.nnet3 import Desc, Nnet3, TdnnComponent, net_tensors
from .streaming import StreamingAm


def _desc_context(net: Nnet3, d: Desc, memo) -> tuple:
    """(left, right) context of a descriptor in input frames."""
    if d.op == "node":
        return _node_context(net, d.args[0], memo)
    if d.op in ("append", "sum"):
        ls, rs = zip(*(_desc_context(net, a, memo) for a in d.args))
        return max(ls), max(rs)
    if d.op == "offset":
        l, r = _desc_context(net, d.args[0], memo)
        t = d.args[1]
        return l + max(-t, 0), r + max(t, 0)
    if d.op == "scale":
        return _desc_context(net, d.args[1], memo)
    if d.op == "const":
        return 0, 0
    if d.op in ("replace_index",):
        return 0, 0
    if d.op == "round":
        l, r = _desc_context(net, d.args[0], memo)
        return l, r + d.args[1]
    if d.op in ("ifdefined", "failover"):
        return _desc_context(net, d.args[0], memo)
    return 0, 0


def _node_context(net: Nnet3, name: str, memo) -> tuple:
    if name in memo:
        return memo[name]
    nd = net.nodes[name]
    if nd.kind == "input":
        memo[name] = (0, 0)
        return (0, 0)
    l, r = _desc_context(net, nd.descriptor, memo)
    if nd.kind == "component":
        comp = net.components[nd.component]
        if isinstance(comp, TdnnComponent):
            offs = comp.time_offsets
            l += max(-min(offs), 0)
            r += max(max(offs), 0)
    memo[name] = (l, r)
    return (l, r)


class Nnet3Am(StreamingAm, nn.Module):
    def __init__(
        self,
        net: Nnet3,
        subsample: int = 3,
        priors: Optional[np.ndarray] = None,
        acoustic_input: str = "input",
        ivector_input: str = "ivector",
        output: str = "output",
        device="cuda",
    ):
        super().__init__()
        self._own_programs()
        net.check_acyclic()
        self.net = net
        self._subsample = subsample
        self.output = output
        self.acoustic_input = acoustic_input
        self.ivector_input = ivector_input
        self._device = torch.device(device)
        self.log_priors = (
            torch.as_tensor(np.log(np.maximum(priors, 1e-20)).astype(np.float32),
                            device=self._device)
            if priors is not None and len(priors)
            else None
        )
        self._feat_dim = net.nodes[acoustic_input].dim
        self.has_ivector = ivector_input in net.nodes
        memo: Dict[str, tuple] = {}
        l, r = _node_context(net, output, memo)
        self._left, self._right = int(l), int(r)
        self.weights = net_tensors(net, self._device)

    @property
    def device(self) -> torch.device:
        return self._device

    # context/dims for StreamingAm
    @property
    def feat_dim(self) -> int:
        return self._feat_dim

    @property
    def subsample(self) -> int:
        return self._subsample

    @property
    def left_context(self) -> int:
        return max(self._left, 1)

    @property
    def right_context(self) -> int:
        return max(self._right, 1)

    def forward(self, window: torch.Tensor, ivector=None) -> torch.Tensor:
        """window: [B, W, D] (ivector [B, I]) -> [B, ceil(W/ss), P]."""
        inputs = {self.acoustic_input: window.to(torch.float32)}
        if self.has_ivector:
            if ivector is None:
                raise ValueError("model expects an i-vector input")
            inputs[self.ivector_input] = ivector.to(torch.float32)[:, None, :]
        out = self.net.evaluate(inputs, self.weights, output=self.output)
        if self.log_priors is not None:
            out = out - self.log_priors
        return out[:, :: self._subsample]
