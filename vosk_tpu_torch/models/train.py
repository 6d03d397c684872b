"""Minimal frame-level acoustic-model training, in PyTorch.

Port of `vosk_tpu/models/train.py` (`train_frame_ce`): frame cross-entropy
on aligned data over the whole padded set each step, Adam.  The reference
has no in-process training (its recipe is a Kaldi bash pipeline,
training/run.sh); this small trainer produces test and demo models.

`AdamTrainer` is the loop both trainers here and `models/chain.py` share:
f32 master parameters on the device, `torch.optim.Adam` (optax.adam's
formula and defaults: 0.9, 0.999, eps 1e-8 outside the square root), one
`step()` per update.  Parameters come from the source's seeded numpy
initialiser and go back as its numpy dict, under the same keys.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .tdnnf import TdnnfConfig, TdnnfModel, init_params


class AdamTrainer:
    """Adam over the tensors in `params` (leaves with gradients) against
    `loss_fn()`, which returns (loss, aux dict).  After `step()` each
    parameter's `.grad` holds that step's gradient."""

    def __init__(self, params: Dict[str, torch.Tensor], loss_fn: Callable, lr: float):
        self.params = params
        self.loss_fn = loss_fn
        self.opt = torch.optim.Adam(list(params.values()), lr=lr)

    def step(self):
        """One update; returns (loss, aux) of the parameters it started from,
        as tensors on the device."""
        self.opt.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn()
        loss.backward()
        self.opt.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def numpy_params(self) -> Dict[str, np.ndarray]:
        """The parameters as the source's dict of float32 numpy arrays."""
        return {k: v.detach().cpu().numpy() for k, v in self.params.items()}

    def grad_norm(self) -> float:
        """L2 norm of the last step's gradient over every parameter."""
        return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in self.params.values())))


def frame_ce_trainer(cfg: TdnnfConfig, feats, labels, lr: float = 3e-3, seed: int = 0,
                     device="cuda") -> AdamTrainer:
    """The trainer `train_frame_ce` runs: feats [N, T, D], labels
    [N, ceil(T/ss)] pdf targets (numpy), on `device`."""
    model = TdnnfModel(cfg, init_params(cfg, seed), device=device, trainable=True)
    x = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=device)

    def loss_fn():
        logp = torch.log_softmax(model.forward_utterance(x), dim=-1)  # [N, T_out, P]
        return -torch.gather(logp, 2, y[..., None]).mean(), {}

    return AdamTrainer(dict(model.params.items()), loss_fn, lr)


def train_frame_ce(
    cfg: TdnnfConfig,
    feats: np.ndarray,   # [N, T, D]
    labels: np.ndarray,  # [N, ceil(T/ss)] pdf targets
    steps: int = 300,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Returns the trained parameter dict (numpy)."""
    trainer = frame_ce_trainer(cfg, feats, labels, lr, seed, device)
    for i in range(steps):
        loss, _ = trainer.step()
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {float(loss):.4f}")
    return trainer.numpy_params()
