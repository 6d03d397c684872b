"""Kaldi `rnnlm/` directory loading and scoring, in PyTorch.

Port of `vosk_tpu/io/kaldi_rnnlm.py`.  The reference loads four artifacts
(model.cc:316-339):
  rnnlm/final.raw                 nnet3 network (no TransitionModel)
  rnnlm/feat_embedding.final.mat  feature-embedding matrix [feat_dim, emb]
  rnnlm/word_feats.txt            sparse word features (per line:
                                  word_id  feat_idx feat_val ...)
  rnnlm/special_symbol_opts.conf  --bos-symbol/--eos-symbol/--brk-symbol
and composes the word-embedding matrix as word_features @
feature_embedding (AddSmatMat at model.cc:330-334).

`read_rnnlm_dir` parses the four files on the host (the loader's
warn-and-skip covers it); `KaldiRnnlmRescorer` carries the network and the
word embedding to its device.  One change in how, not in what: the source
forms the embedding through a dense [num_words, feat_dim] word-feature
matrix (about 8 GB at 100k words and 20k features); the port keeps each
word's features as padded (index, value) rows and accumulates the same
product on the device, feature by feature, without the dense matrix.

Scoring: feedforward TDNN-style RNNLMs run over a bounded word-history
window padded with <brk> embeddings to the net's receptive field;
recurrent (LSTM) nets take nnet3's time-stepped recurrent evaluator over
the same bounded window — the truncation Kaldi's own RnnlmDeterministicFst
applies via --max-ngram-order.  Output logits use the tied embedding.  Per
history the [num_words] logit row is copied to the host once and cached,
so scoring a lattice arc is a host read, not a device sync.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.am import _node_context
from ..utils.config import read_config_file
from .kaldiio import open_kaldi, read_kaldi_matrix
from .nnet3 import Nnet3, net_tensors


@dataclasses.dataclass
class KaldiRnnlm:
    """A parsed rnnlm/ dir, on the host."""
    net: Nnet3
    feat_embedding: np.ndarray  # [feat_dim, emb_dim]
    feat_idx: np.ndarray        # [num_words, max_feats] int64, padded with 0
    feat_val: np.ndarray        # [num_words, max_feats] f32, padded with 0.0
    bos: int
    eos: int
    brk: int
    left_context: int = 0       # word rows the net reads before / after the
    right_context: int = 0      # one it predicts from (0 for recurrent nets)


def read_sparse_word_features(path, feat_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """word_feats.txt -> (indices, values) [num_words, max_feats], each
    word's features in file order, padded with (0, 0.0); the rows of the
    source's dense matrix (rnnlm::ReadSparseWordFeatures, model.cc:325-328):
    a feature listed twice for a word keeps its last value."""
    rows: Dict[int, Dict[int, float]] = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        wid = int(parts[0])
        feats = parts[1:]
        if len(feats) % 2:
            raise ValueError(f"{path}: odd feature list for word {wid}")
        row = rows.setdefault(wid, {})
        for i in range(0, len(feats), 2):
            idx = int(feats[i])
            if not (0 <= idx < feat_dim):
                raise ValueError(f"{path}: feature index {idx} >= {feat_dim}")
            row[idx] = float(feats[i + 1])
    num_words = max(rows) + 1 if rows else 0
    width = max((len(r) for r in rows.values()), default=0)
    idx = np.zeros((num_words, width), np.int64)
    val = np.zeros((num_words, width), np.float32)
    for wid, row in rows.items():
        idx[wid, :len(row)] = list(row)
        val[wid, :len(row)] = list(row.values())
    return idx, val


def word_embedding(lm: KaldiRnnlm, device) -> torch.Tensor:
    """The [num_words, emb_dim] word embedding word_features @
    feature_embedding on `device`, accumulated one feature slot at a time
    over all words."""
    femb = torch.as_tensor(lm.feat_embedding, dtype=torch.float32, device=device)
    idx = torch.as_tensor(lm.feat_idx, device=device)
    val = torch.as_tensor(lm.feat_val, device=device)
    out = torch.zeros((idx.shape[0], femb.shape[1]), dtype=torch.float32, device=device)
    for k in range(idx.shape[1]):
        out += val[:, k, None] * femb[idx[:, k]]
    return out


def read_rnnlm_dir(path) -> KaldiRnnlm:
    p = Path(path)
    feat_embedding = read_kaldi_matrix(p / "feat_embedding.final.mat")
    feat_idx, feat_val = read_sparse_word_features(p / "word_feats.txt",
                                                   feat_embedding.shape[0])
    opts = read_config_file(p / "special_symbol_opts.conf")
    r, binary = open_kaldi(p / "final.raw")
    if not binary:
        raise ValueError("text-mode final.raw not supported")
    net = Nnet3.read(r)
    lm = KaldiRnnlm(net, np.asarray(feat_embedding, np.float32), feat_idx, feat_val,
                    bos=int(opts.get("bos-symbol", 1)), eos=int(opts.get("eos-symbol", 2)),
                    brk=int(opts.get("brk-symbol", 3)))
    if not net.has_recurrence():
        # recurrent (LSTM) nets consume the whole history window via their
        # back-edges and need no receptive-field padding; a feedforward
        # net's output reads lc embedded words before the prediction
        lc, rc = _node_context(net, "output", {})
        lm.left_context, lm.right_context = max(lc, 0), max(rc, 0)
    return lm


class KaldiRnnlmRescorer:
    """Deterministic rescoring adapter (score/final_cost/initial_state)
    over a loaded Kaldi RNNLM with a bounded word-history window, on
    `device`.

    Kaldi's own rescoring runs the network incrementally per lattice state
    (kaldi::rnnlm::RnnlmDeterministicFst); with feedforward (TDNN) RNNLMs a
    bounded history is exact up to the network's left context.  Output
    logits use the tied embedding: logit(w) = out . word_embedding[w]
    (Kaldi's sampling-trained RNNLMs treat the unnormalized logit as a
    log-prob, rnnlm-compute-state.cc).  `evaluated` and `seconds` count the
    histories run through the net and the host time they took.
    """

    def __init__(self, lm: KaldiRnnlm, history: int = 4, device="cuda"):
        self.lm = lm
        self.history = history
        self.left_context, self.right_context = lm.left_context, lm.right_context
        self.device = torch.device(device)
        self.weights = net_tensors(lm.net, self.device)
        self.word_embedding = word_embedding(lm, self.device)
        if self.device.type == "cuda":  # load time includes the product
            torch.cuda.synchronize(self.device)
        self.evaluated, self.seconds = 0, 0.0
        self._cache: Dict[Tuple[int, ...], np.ndarray] = {}

    def initial_state(self) -> Tuple[int, ...]:
        return (self.lm.bos,)

    def logits(self, state: Tuple[int, ...]) -> torch.Tensor:
        """The [num_words] logit row after `state`, on the device."""
        emb = self.word_embedding
        if max(state) >= len(emb):  # checked on the host: no device assert
            raise IndexError(f"word {max(state)} is past the RNNLM's {len(emb)} words")
        rows = [emb[list(state)]]  # [T, emb]
        # pad the network's receptive field with <brk> embeddings: lc
        # history rows on the left, rc rows on the right so the final valid
        # output row aligns with the last real word
        lpad = max(self.left_context - len(state) + 1, 0)
        brk = emb[self.lm.brk][None]
        if lpad:
            rows.insert(0, brk.expand(lpad, -1))
        if self.right_context:
            rows.append(brk.expand(self.right_context, -1))
        with torch.no_grad():
            hid = self.lm.net.evaluate({"input": torch.cat(rows)[None]}, self.weights,
                                       output="output")[0]
            # evaluate() is same-length (edge-clamped): the row aligned to
            # the last real word sits right_context rows before the end
            last = hid[-1 - self.right_context]
            # Kaldi convention (rnnlm-compute-state.cc LogProbOfWord): the
            # raw unnormalized logit IS the log-prob (self-normalized
            # sampling-trained RNNLMs)
            return emb @ last

    def _logprobs(self, state: Tuple[int, ...]) -> np.ndarray:
        out = self._cache.get(state)
        if out is None:
            t0 = time.perf_counter()
            out = self.logits(state).cpu().numpy()
            self.evaluated += 1
            self.seconds += time.perf_counter() - t0
            self._cache[state] = out
        return out

    def score(self, state: Tuple[int, ...], word: int) -> Tuple[float, Tuple[int, ...]]:
        lp = self._logprobs(state)
        cost = -float(lp[word]) if 0 <= word < len(lp) else 20.0
        ns = (state + (word,))[-self.history:]
        return cost, ns

    def final_cost(self, state: Tuple[int, ...]) -> float:
        cost, _ = self.score(state, self.lm.eos)
        return cost

    def clear(self) -> None:
        self._cache.clear()
