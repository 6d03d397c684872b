"""Minimum Bayes Risk sausage decoding over a word lattice.

Copy of `vosk_tpu/graph/mbr.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

The algorithm the reference uses for its no-alternatives Result() path
(`MinimumBayesRisk` at src/recognizer.cc:440-444, Kaldi
lat/sausages.cc): iteratively align a reference hypothesis R against the
whole lattice with the expected-edit-distance recursion of Xu, Povey,
Mangu & Zhou (2011), producing per-position word posteriors ("sausage
bins") and expected word times; R is re-estimated from the bin argmaxes
until it stops changing.

Differences from the pooled-occurrence confidences this replaced
(runtime/finishing.py history): the MBR gamma for a word is the posterior
that THIS sausage position carries the word under the edit-distance
alignment — competing alignments of the same word merge exactly, and
substitution competitors lower the confidence even when they never share
a time anchor.

Implementation notes (mirroring Kaldi semantics):
  * R is epsilon-interleaved each iteration (eps, w1, eps, w2, ..., eps)
    so insertions have positions to land on.
  * edit cost l(a, b) = 0 if a == b else 1 (epsilon = 0 participates).
  * min-choice ties prefer substitution/match (a1) over insertion (a2)
    over deletion (a3), matching the Kaldi comparison order.
  * arc "probability" uses the lattice's combined graph+acoustic cost
    (the caller applies acoustic/graph scaling before building us, the
    same point in the chain where the reference calls MBR).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

NEG_INF = -math.inf


@dataclasses.dataclass
class SausageBin:
    words: Dict[int, float]  # word -> posterior (0 = epsilon)
    t_begin: float  # expected begin frame of the bin's word mass
    t_end: float


def _logadd(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


class _WordGraph:
    """Topologically-numbered arc list view of a Lattice with a single
    super-final node; arcs carry (src, dst, word, cost, f0, f1)."""

    def __init__(self, lat):
        n = lat.num_nodes
        self.N = n + 1
        self.final = n  # super-final node id
        self.arcs: List[Tuple[int, int, int, float, int, int]] = []
        for a in lat.arcs:
            self.arcs.append(
                (a.src, a.dst, a.olabel, a.cost,
                 lat.node_frame[a.src], lat.node_frame[a.dst])
            )
        for u in range(n):
            if math.isfinite(lat.final[u]):
                self.arcs.append(
                    (u, self.final, 0, float(lat.final[u]),
                     lat.node_frame[u], lat.node_frame[u])
                )
        self.pre: List[List[int]] = [[] for _ in range(self.N)]
        for i, (s, d, w, c, f0, f1) in enumerate(self.arcs):
            self.pre[d].append(i)


def _interleave_eps(words: List[int]) -> List[int]:
    out = [0]
    for w in words:
        out.append(w)
        out.append(0)
    return out


def mbr_decode(lat, max_iters: int = 20):
    """Run MBR sausage decoding on a built Lattice.

    Returns (words, bins) where words = [(word_id, conf, t_begin, t_end)]
    for the non-epsilon sausage positions and bins = [SausageBin] for every
    position (epsilon bins included, confidence mass normalized per bin
    occupancy like Kaldi's sausage stats).
    """
    best_cost, best_path = lat.shortest()
    if not best_path and not any(math.isfinite(f) for f in lat.final):
        return [], []
    R = [lat.arcs[ai].olabel for ai in best_path if lat.arcs[ai].olabel != 0]
    g = _WordGraph(lat)

    # forward log-probs alpha(n) over the graph, fixed across iterations
    alpha = [NEG_INF] * g.N
    alpha[0] = 0.0
    for n_ in range(1, g.N):
        acc = NEG_INF
        for ai in g.pre[n_]:
            s, _, _, c, _, _ = g.arcs[ai]
            if alpha[s] != NEG_INF:
                acc = _logadd(acc, alpha[s] - c)
        alpha[n_] = acc
    if alpha[g.final] == NEG_INF:
        return [], []

    gamma: List[Dict[int, float]] = []
    tau: List[List[float]] = []
    Rp: List[int] = []
    for _ in range(max_iters):
        Rp = _interleave_eps(R)
        gamma, tau = _acc_stats(g, alpha, Rp)
        R_new = []
        changed = False
        for q in range(1, len(Rp) + 1):
            bin_q = gamma[q - 1]
            w_best = max(bin_q.items(), key=lambda kv: (kv[1], -kv[0]))[0] \
                if bin_q else 0
            if w_best != Rp[q - 1]:
                changed = True
            if w_best != 0:
                R_new.append(w_best)
        if not changed:
            break
        R = R_new

    bins: List[SausageBin] = []
    words: List[Tuple[int, float, float, float]] = []
    for q in range(len(Rp)):
        mass = sum(gamma[q].values())
        tb, te = tau[q]
        if mass > 0:
            tb, te = tb / mass, te / mass
        bins.append(SausageBin(dict(gamma[q]), tb, te))
        w = Rp[q]
        if w != 0:
            conf = min(gamma[q].get(w, 0.0), 1.0)
            words.append((w, conf, tb, te))
    return words, bins


def _acc_stats(g: _WordGraph, alpha: List[float], R: List[int]):
    """One forward+backward pass of the expected-edit-distance recursion
    against reference R (1-indexed positions; R[q-1] = r_q).  Returns
    (gamma, tau): per-position word->posterior maps and [t_begin, t_end]
    accumulators weighted by occupancy."""
    Q = len(R)
    N = g.N
    INF = float("inf")

    def l(a: int, b: int) -> float:
        return 0.0 if a == b else 1.0

    # alpha_dash[n][q]
    alpha_dash = np.zeros((N, Q + 1))
    for q in range(1, Q + 1):
        alpha_dash[0, q] = alpha_dash[0, q - 1] + l(0, R[q - 1])
    arc_ad = {}  # arc index -> alpha_dash_arc row (saved for backward)
    for n_ in range(1, N):
        row = np.zeros(Q + 1)
        for ai in g.pre[n_]:
            s, _, w_a, c, f0, f1 = g.arcs[ai]
            if alpha[s] == NEG_INF:
                continue
            scale = math.exp(alpha[s] - c - alpha[n_])
            ad = np.empty(Q + 1)
            ad[0] = alpha_dash[s, 0] + l(w_a, 0)
            for q in range(1, Q + 1):
                a1 = alpha_dash[s, q - 1] + l(w_a, R[q - 1])
                a2 = alpha_dash[s, q] + l(w_a, 0)
                a3 = ad[q - 1] + l(0, R[q - 1])
                # tie order: substitution/match, insertion, deletion
                if a1 <= a2 and a1 <= a3:
                    ad[q] = a1
                elif a2 <= a3:
                    ad[q] = a2
                else:
                    ad[q] = a3
            arc_ad[ai] = ad
            row += scale * ad
        alpha_dash[n_] = row

    # backward occupancies.  beta_dash[n][q] = expected number of times a
    # path passes node n aligned with exactly q consumed reference words;
    # within one arc, deletion choices cascade mass down the arc's own
    # beta_dash_arc row before anything flows to the source node (Kaldi's
    # beta_dash_arc loop in sausages.cc AccStats).
    beta_dash = np.zeros((N, Q + 1))
    beta_dash[g.final, Q] = 1.0
    gamma: List[Dict[int, float]] = [dict() for _ in range(Q)]
    tau = [[0.0, 0.0] for _ in range(Q)]
    for n_ in range(N - 1, 0, -1):
        for ai in g.pre[n_]:
            s, _, w_a, c, f0, f1 = g.arcs[ai]
            if alpha[s] == NEG_INF or ai not in arc_ad:
                continue
            scale = math.exp(alpha[s] - c - alpha[n_])
            ad = arc_ad[ai]
            beta_arc = 0.0  # deletion cascade carried from q+1 to q
            for q in range(Q, -1, -1):
                b = beta_dash[n_, q] * scale + beta_arc
                beta_arc = 0.0
                if b == 0.0:
                    continue
                if q == 0:
                    # only the insertion-like branch exists at q=0
                    beta_dash[s, 0] += b
                    continue
                a1 = alpha_dash[s, q - 1] + l(w_a, R[q - 1])
                a2 = alpha_dash[s, q] + l(w_a, 0)
                a3 = ad[q - 1] + l(0, R[q - 1])
                if a1 <= a2 and a1 <= a3:
                    # w_a aligned to position q (match or substitution)
                    beta_dash[s, q - 1] += b
                    gamma[q - 1][w_a] = gamma[q - 1].get(w_a, 0.0) + b
                    tau[q - 1][0] += b * f0
                    tau[q - 1][1] += b * f1
                elif a2 <= a3:
                    # w_a inserted (consumes no reference position); Kaldi
                    # still credits the word to bin q's stats
                    beta_dash[s, q] += b
                    if w_a != 0:
                        gamma[q - 1][w_a] = gamma[q - 1].get(w_a, 0.0) + b
                        tau[q - 1][0] += b * f0
                        tau[q - 1][1] += b * f1
                else:
                    # r_q deleted: epsilon occupies position q; the mass
                    # stays on this arc and re-enters at q-1
                    beta_arc = b
                    gamma[q - 1][0] = gamma[q - 1].get(0, 0.0) + b
    return gamma, tau
