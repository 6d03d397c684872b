"""LF-MMI ("chain") acoustic-model training, in PyTorch.

Port of `vosk_tpu/models/chain.py`.  The reference's acoustic models are
trained with Kaldi's lattice-free MMI recipe (training/run.sh stages 4-5,
local/chain/run_tdnn.sh:135-166); the objective is

    F = sum_u [ log p(O_u | num_u) - log p(O_u | den) ]

as in the source:

  * `DenominatorGraph` is a numpy copy of the source's (a bigram phone LM
    over pdfs with add-k smoothing, from the training alignments);
    `graph_to(den, device)` carries its arrays to the device once;
  * `den_logprob` is the denominator forward recursion in probability
    space with per-frame renormalisation, a Python loop over frames: the
    leaky-HMM rank-1 leak, then `a @ T` (one [B, S] x [S, S] product a
    frame), then the emission, clamped at 1e-30 as the source does.
    Autograd runs back through the loop (the source differentiates its
    `lax.scan`), keeping about five [B, S] tensors a frame;
  * `num_logprob` scores the forced alignment (a linear FSA) with the same
    transition model; `chain_objective` adds the cross-entropy
    regulariser (Kaldi --xent-regularize 0.1).

These are torch ops, as the source leaves them to XLA: the path reaches no
Pallas kernel.  Keep TF32 off (`torch.backends.cuda.matmul.allow_tf32`,
False by default) for the transition product, whose probabilities are f32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .tdnnf import TdnnfConfig, TdnnfModel, init_params
from .train import AdamTrainer


@dataclasses.dataclass
class DenominatorGraph:
    """Phone-LM HMM in dense form: state = pdf (1-state-per-phone topology,
    the toy/demo topology; chain-topology trees map similarly with one
    state per pdf-class).

    trans: [S, S] transition probabilities (rows sum to <= 1; the leftover
    mass is the final probability), built from a bigram phone LM with
    self-loops.  init: [S] initial probabilities.
    """

    trans: np.ndarray  # [S, S] probabilities
    init: np.ndarray   # [S]
    final: np.ndarray  # [S]
    # leaky-HMM coefficient (Kaldi default 0.1): per-frame rank-1 leak
    # through a virtual hub distributed by `init`, the numerical aid the
    # reference recipe applies to the denominator recursion
    leaky_hmm: float = 0.0

    @classmethod
    def from_alignments(
        cls,
        labels: np.ndarray,  # [N, T] pdf targets (the training alignments)
        num_pdfs: int,
        discount: float = 0.1,
    ) -> "DenominatorGraph":
        """Estimate the phone bigram (with add-k smoothing) from the
        training alignments — the role of Kaldi's chain den phone LM
        (chain-den-graph.cc builds it from the numerator alignments the
        same way)."""
        S = num_pdfs
        big = np.full((S, S), discount, np.float64)
        init = np.full(S, discount, np.float64)
        fin = np.full(S, discount, np.float64)
        for row in np.asarray(labels):
            init[row[0]] += 1
            fin[row[-1]] += 1
            a, b = row[:-1], row[1:]
            np.add.at(big, (a, b), 1)
        # rows normalized together with the final mass
        tot = big.sum(1) + fin
        trans = big / tot[:, None]
        final = fin / tot
        return cls(
            trans=trans.astype(np.float32),
            init=(init / init.sum()).astype(np.float32),
            final=final.astype(np.float32),
        )


_ARRAYS = ("trans", "init", "final")


def _arrays(den: DenominatorGraph, device):
    return tuple(torch.as_tensor(getattr(den, k), dtype=torch.float32, device=device)
                 for k in _ARRAYS)


def graph_to(den: DenominatorGraph, device) -> DenominatorGraph:
    """The same graph with trans / init / final as f32 tensors on `device`
    (the functions below take either form)."""
    return dataclasses.replace(den, **dict(zip(_ARRAYS, _arrays(den, device))))


def den_logprob(den: DenominatorGraph, ll: torch.Tensor) -> torch.Tensor:
    """log p(O | den) per utterance.  ll: [B, T, S] pseudo-log-likelihoods
    (the network output; chain models are trained without priors).

    Probability-space forward with per-frame renormalisation: alpha is kept
    as (unit-scaled probs, log-scale) so the transition step is one matmul
    a frame."""
    T, init, fin = _arrays(den, ll.device)
    m0 = torch.max(ll[:, 0], dim=1, keepdim=True).values
    a = init[None, :] * torch.exp(ll[:, 0] - m0)
    n0 = a.sum(dim=1)
    a = a / n0[:, None]
    logscale = m0[:, 0] + torch.log(n0)
    leaky = float(den.leaky_hmm)
    for t in range(1, ll.shape[1]):
        ll_t = ll[:, t]
        if leaky > 0.0:
            # leaky-HMM (Kaldi chain-denominator-graph leaky_hmm_coefficient,
            # default 0.1): every state leaks mass through a virtual hub
            # distributed by the initial probabilities, a rank-1 update
            a = a + leaky * a.sum(dim=1, keepdim=True) * init[None, :]
        m = torch.max(ll_t, dim=1, keepdim=True).values
        a2 = (a @ T) * torch.exp(ll_t - m)
        n = torch.clamp(a2.sum(dim=1), min=1e-30)
        a = a2 / n[:, None]
        logscale = logscale + m[:, 0] + torch.log(n)
    return logscale + torch.log(torch.clamp((a * fin[None]).sum(dim=1), min=1e-30))


def num_logprob(den: DenominatorGraph, ll: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """log p(O, alignment | num): linear-FSA numerator score along the
    forced alignment, with the SAME transition model as the denominator so
    the two terms are comparable."""
    trans, init, fin = _arrays(den, ll.device)
    em = torch.gather(ll, 2, labels[..., None])[..., 0]  # [B, T]
    lt = torch.log(torch.clamp(trans, min=1e-30))
    li = torch.log(torch.clamp(init, min=1e-30))
    lf = torch.log(torch.clamp(fin, min=1e-30))
    tr = lt[labels[:, :-1], labels[:, 1:]]  # [B, T-1]
    return em.sum(1) + tr.sum(1) + li[labels[:, 0]] + lf[labels[:, -1]]


def chain_objective(den: DenominatorGraph, ll, labels, xent_scale: float = 0.1):
    """(negated) LF-MMI objective + cross-entropy regularisation.
    Returns (loss, aux dict)."""
    num = num_logprob(den, ll, labels)
    dn = den_logprob(den, ll)
    mmi = torch.mean(num - dn) / ll.shape[1]
    logp = torch.log_softmax(ll, dim=-1)
    xent = torch.mean(torch.gather(logp, 2, labels[..., None]))
    loss = -(mmi + xent_scale * xent)
    return loss, {"mmi": mmi, "xent": xent}


def chain_trainer(cfg: TdnnfConfig, feats, labels, lr: float = 2e-3, seed: int = 0,
                  xent_scale: float = 0.1, den: Optional[DenominatorGraph] = None,
                  device="cuda") -> AdamTrainer:
    """The trainer `train_chain` runs: feats [N, T, D], labels [N, T_l] pdf
    alignment targets (numpy), on `device`; `den` defaults to the bigram of
    `labels` with the reference recipe's leak, 0.1 (run_tdnn.sh)."""
    if den is None:
        den = DenominatorGraph.from_alignments(labels, cfg.num_pdfs)
        den.leaky_hmm = 0.1
    den = graph_to(den, device)
    model = TdnnfModel(cfg, init_params(cfg, seed), device=device, trainable=True)
    x = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=device)

    def loss_fn():
        out = model.forward_utterance(x)[:, : y.shape[1]]  # [N, T_l, P]
        return chain_objective(den, out, y, xent_scale)

    return AdamTrainer(dict(model.params.items()), loss_fn, lr)


def train_chain(
    cfg: TdnnfConfig,
    feats: np.ndarray,   # [N, T, D]
    labels: np.ndarray,  # [N, ceil(T/ss)] pdf alignment targets
    steps: int = 300,
    lr: float = 2e-3,
    seed: int = 0,
    xent_scale: float = 0.1,
    log_every: int = 0,
    den: Optional[DenominatorGraph] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """LF-MMI training loop (the in-process equivalent of the reference's
    training/run.sh stage 4; same API shape as train_frame_ce)."""
    trainer = chain_trainer(cfg, feats, labels, lr, seed, xent_scale, den, device)
    for i in range(steps):
        loss, aux = trainer.step()
        if log_every and i % log_every == 0:
            print(
                f"chain step {i}: loss {float(loss):.4f} "
                f"mmi {float(aux['mmi']):.4f} xent {float(aux['xent']):.4f}"
            )
    return trainer.numpy_params()
