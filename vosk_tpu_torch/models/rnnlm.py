"""Neural (RNN) language model rescoring, in PyTorch.

Port of `vosk_tpu/models/rnnlm.py`.  Reference counterpart: Kaldi RNNLM
lattice rescoring (loaded at src/model.cc:316-339, applied at
src/recognizer.cc:696-705 as a 0.5/-0.5 mixture with the const-ARPA).

`RnnlmModel` is the native GRU word LM as an `nn.Module` whose parameters
live on its device; `step` is the source's `_step_impl`.  `RnnlmRescorer`
exposes the deterministic-LM interface (initial_state/score/final_cost)
used by graph/lattice.rescore_lattice, with states = truncated word
histories and hidden vectors memoized per history on the device.  One
change of mechanism: each history's log-prob row is copied to the host
once and scored there, so scoring a lattice arc is a host read, not a
device sync.  `MixtureLm` combines scorers with weights.  `init_rnnlm_params`
is the source's seeded numpy initializer; `params_from_numpy` carries a
parameter dict (the source's or a saved one) to a device.  `train_rnnlm`
is the source's trainer: the GRU cell (`gru_cell`, the one `step` runs)
unrolled over padded sentences with teacher forcing, masked next-word
cross-entropy, Adam (`models/train.py` AdamTrainer).
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class RnnlmConfig:
    vocab_size: int = 16          # word ids 0..vocab_size-1; 0 unused
    embed_dim: int = 16
    hidden_dim: int = 32
    bos: int = 1_000_000          # virtual ids for sentence markers
    eos: int = 1_000_001


def init_rnnlm_params(cfg: RnnlmConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    V = cfg.vocab_size + 2  # + bos/eos rows
    return {
        "embed": mat(V, cfg.embed_dim),
        "gru_wz": mat(cfg.embed_dim + cfg.hidden_dim, cfg.hidden_dim),
        "gru_wr": mat(cfg.embed_dim + cfg.hidden_dim, cfg.hidden_dim),
        "gru_wh": mat(cfg.embed_dim + cfg.hidden_dim, cfg.hidden_dim),
        "out_w": mat(cfg.hidden_dim, V),
        "out_b": np.zeros(V, np.float32),
    }


def params_from_numpy(params, device="cuda") -> Dict[str, torch.Tensor]:
    """A parameter dict of arrays as float32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def save_rnnlm(path, cfg: RnnlmConfig, params: Dict[str, np.ndarray]) -> None:
    """The source's `RnnlmModel.save` layout: `vosk_tpu_rnnlm.json` (the
    config) + `rnnlm.npz` (the parameters)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    (p / "vosk_tpu_rnnlm.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    np.savez(p / "rnnlm.npz", **params)


def gru_cell(p, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step: embeddings x [..., E] and hidden h [..., H] -> the new
    hidden [..., H] (the source's `_step_impl` and `train_rnnlm` cell)."""
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["gru_wz"])
    r = torch.sigmoid(xh @ p["gru_wr"])
    hc = torch.tanh(torch.cat([x, r * h], dim=-1) @ p["gru_wh"])
    return (1 - z) * h + z * hc


class RnnlmModel(nn.Module):
    def __init__(self, cfg: RnnlmConfig, params, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = params_from_numpy(params, self.device)

    def _wid(self, w: int) -> int:
        if w == self.cfg.bos:
            return self.cfg.vocab_size
        if w == self.cfg.eos:
            return self.cfg.vocab_size + 1
        return min(max(w, 0), self.cfg.vocab_size - 1)

    def init_hidden(self) -> torch.Tensor:
        return torch.zeros(self.cfg.hidden_dim, dtype=torch.float32, device=self.device)

    def step(self, h: torch.Tensor, word: int):
        """(new hidden, log-probs over extended vocab), both on the device."""
        p = self.params
        h2 = gru_cell(p, p["embed"][self._wid(word)], h)
        logits = h2 @ p["out_w"] + p["out_b"]
        return h2, torch.log_softmax(logits, dim=-1)

    def save(self, path) -> None:
        save_rnnlm(path, self.cfg, {k: v.cpu().numpy() for k, v in self.params.items()})

    @classmethod
    def load(cls, path, device="cuda") -> "RnnlmModel":
        p = Path(path)
        cfg = RnnlmConfig(**json.loads((p / "vosk_tpu_rnnlm.json").read_text()))
        z = np.load(p / "rnnlm.npz")
        return cls(cfg, {k: z[k] for k in z.files}, device=device)


class RnnlmRescorer:
    """Deterministic-LM adapter over RnnlmModel with truncated-history
    state virtualization (lm_order as in the reference, recognizer.cc:179).
    `evaluated` and `seconds` count the histories run through the model and
    the host time they took (each ends in the row's copy to the host)."""

    def __init__(self, model: RnnlmModel, lm_order: int = 4):
        self.model = model
        self.hist_len = lm_order - 1
        self.evaluated, self.seconds = 0, 0.0
        # history tuple -> (hidden after consuming history on the device,
        # log-probs for the next word on the host)
        self._cache: Dict[Tuple[int, ...], tuple] = {(): self._step(model.init_hidden(),
                                                                    model.cfg.bos)}

    def _step(self, h, word):
        t0 = time.perf_counter()
        with torch.no_grad():
            h2, logp = self.model.step(h, word)
        out = (h2, logp.cpu().numpy())
        self.evaluated += 1
        self.seconds += time.perf_counter() - t0
        return out

    def initial_state(self) -> Tuple[int, ...]:
        return ()

    def _get(self, hist: Tuple[int, ...]):
        if hist in self._cache:
            return self._cache[hist]
        ph, _ = self._get(hist[:-1])
        self._cache[hist] = self._step(ph, hist[-1])
        return self._cache[hist]

    def score(self, state: Tuple[int, ...], word: int) -> Tuple[float, Tuple[int, ...]]:
        _, logp = self._get(state)
        cost = -float(logp[self.model._wid(word)])
        ns = (state + (word,))[-self.hist_len:]
        return cost, ns

    def final_cost(self, state: Tuple[int, ...]) -> float:
        _, logp = self._get(state)
        return -float(logp[self.model._wid(self.model.cfg.eos)])

    def clear(self) -> None:
        """Drop memoized hidden states between utterances (the reference
        calls rnnlm_to_add_->Clear(), recognizer.cc:705)."""
        self._cache = {(): self._cache[()]}


class MixtureLm:
    """Weighted sum of deterministic LMs (the carpa/rnnlm 0.5/0.5 mixture)."""

    def __init__(self, parts: List[Tuple[float, object]]):
        self.parts = parts

    def initial_state(self):
        return tuple(p.initial_state() for _, p in self.parts)

    def score(self, state, word):
        total = 0.0
        ns = []
        for (wgt, lm), st in zip(self.parts, state):
            c, s2 = lm.score(st, word)
            total += wgt * c
            ns.append(s2)
        return total, tuple(ns)

    def final_cost(self, state):
        return sum(wgt * lm.final_cost(st) for (wgt, lm), st in zip(self.parts, state))


def rnnlm_trainer(cfg: RnnlmConfig, sentences: List[List[int]], lr: float = 1e-2,
                  seed: int = 0, device="cuda"):
    """The trainer `train_rnnlm` runs: every sentence (word ids) a row of
    one padded batch, bos-prefixed inputs, eos-terminated targets."""
    from .train import AdamTrainer

    model = RnnlmModel(cfg, init_rnnlm_params(cfg, seed), device=device)
    bos_id, eos_id = cfg.vocab_size, cfg.vocab_size + 1
    T = max(len(s) for s in sentences) + 1
    N = len(sentences)
    inp = np.full((N, T), eos_id, np.int64)
    tgt = np.full((N, T), -1, np.int64)
    for i, s in enumerate(sentences):
        ids = [bos_id] + [model._wid(w) for w in s]
        out = [model._wid(w) for w in s] + [eos_id]
        inp[i, : len(ids)] = ids
        tgt[i, : len(out)] = out
    params = {k: v.requires_grad_() for k, v in model.params.items()}
    inp_t = torch.as_tensor(inp.T.copy(), device=device)  # [T, N]
    tgt_t = torch.as_tensor(tgt.T.copy(), device=device)
    mask = (tgt_t >= 0).to(torch.float32)

    def loss_fn():
        p = params
        h = torch.zeros((N, cfg.hidden_dim), dtype=torch.float32, device=device)
        hs = []
        for t in range(T):
            h = gru_cell(p, p["embed"][inp_t[t]], h)
            hs.append(h)
        logits = torch.stack(hs) @ p["out_w"] + p["out_b"]  # [T, N, V]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 2, torch.clamp(tgt_t, min=0)[..., None])[..., 0]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1), {}

    return AdamTrainer(params, loss_fn, lr)


def train_rnnlm(
    cfg: RnnlmConfig,
    sentences: List[List[int]],
    steps: int = 200,
    lr: float = 1e-2,
    seed: int = 0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Tiny next-word CE trainer (teacher forcing over padded batches)."""
    trainer = rnnlm_trainer(cfg, sentences, lr, seed, device)
    for _ in range(steps):
        trainer.step()
    return trainer.numpy_params()
