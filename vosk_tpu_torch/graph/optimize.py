"""Graph transformations that shape decoding graphs for the decoder's
dense arc layout.

Copy of `vosk_tpu/graph/optimize.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

- `remove_epsilons`: eliminate epsilon arcs whose olabel is 0 by composing
  them into predecessor emitting arcs (and the start state / final costs).
  Removable-eps-free graphs decode in a single phase per frame — no epsilon
  closure rounds, i.e. 2x-3x fewer sorts.
- `split_high_degree`: cap emitting out-degree at M by introducing virtual
  continuation states linked by zero-cost eps arcs; with `remove_epsilons`
  run afterwards this keeps correctness while enabling the dense padded
  [state, M] arc layout.  (High-degree hubs are why Kaldi's decoders use CSR
  + binary search; splitting trades a few extra frontier slots instead.)
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .fst import EPSILON, StdFst


def remove_epsilons(fst: StdFst, max_expansion: int = 64) -> StdFst:
    """Eliminate unlabeled (olabel==0) epsilon arcs.

    For every state s, compute its weighted closure over removable eps arcs:
    {(t, w)} reachable via eps-only paths with total cost w (keeping
    non-removable eps arcs, i.e. those passing through labeled eps arcs, in
    place).  Then each emitting arc into s is redirected: arc (p -> s)
    becomes arcs (p -> t) for all (t, w) in closure(s) with weight +w.
    Closure includes (s, 0) iff s has emitting arcs/finality of its own.
    """
    import heapq

    n = fst.num_states

    # removable eps adjacency
    eps_adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    has_labeled_eps = [False] * n
    for s in range(n):
        for il, ol, w, ns in fst.arcs[s]:
            if il == EPSILON:
                if ol == EPSILON:
                    eps_adj[s].append((ns, w))
                else:
                    has_labeled_eps[s] = True

    def closure(s: int) -> List[Tuple[int, float]]:
        dist = {s: 0.0}
        heap = [(0.0, s)]
        while heap:
            c, u = heapq.heappop(heap)
            if c > dist.get(u, math.inf):
                continue
            for v, w in eps_adj[u]:
                nc = c + w
                if nc < dist.get(v, math.inf) - 1e-12:
                    dist[v] = nc
                    heapq.heappush(heap, (nc, v))
        # keep targets that are "useful": have emitting arcs, labeled eps
        # arcs, or final weight
        out = []
        for t, w in dist.items():
            useful = (
                has_labeled_eps[t]
                or fst.final[t] != math.inf
                or any(il != EPSILON for il, _, _, _ in fst.arcs[t])
            )
            if useful:
                out.append((t, w))
        return sorted(out, key=lambda x: x[1])[:max_expansion]

    closures: Dict[int, List[Tuple[int, float]]] = {}

    def get_closure(s: int) -> List[Tuple[int, float]]:
        if s not in closures:
            closures[s] = closure(s)
        return closures[s]

    out = StdFst()
    out.add_states(n)

    # start state: redirect via closure of start (cheapest copy: keep start,
    # add eps-free arcs from closure targets)
    out.set_start(fst.start)

    for s in range(n):
        # final: best final through closure
        best_final = math.inf
        for t, w in get_closure(s):
            if fst.final[t] != math.inf:
                best_final = min(best_final, w + fst.final[t])
        if best_final != math.inf:
            out.set_final(s, best_final)
        for il, ol, w, ns in fst.arcs[s]:
            if il == EPSILON and ol == EPSILON:
                continue  # removed
            if il == EPSILON:
                # labeled eps arc: keep, but compose its destination closure
                for t, wc in get_closure(ns):
                    out.add_arc(s, EPSILON, ol, w + wc, t)
            else:
                for t, wc in get_closure(ns):
                    out.add_arc(s, il, ol, w + wc, t)

    # also arcs out of the eps-closure of the start state must be reachable:
    # redirecting incoming arcs handles interior states, but the start's own
    # closure targets need their arcs available from the start itself.
    for t, wc in get_closure(fst.start):
        if t == fst.start:
            continue
        for il, ol, w, ns in fst.arcs[t]:
            if il == EPSILON and ol == EPSILON:
                continue
            if il == EPSILON:
                for u, wc2 in get_closure(ns):
                    out.add_arc(fst.start, EPSILON, ol, wc + w + wc2, u)
            else:
                for u, wc2 in get_closure(ns):
                    out.add_arc(fst.start, il, ol, wc + w + wc2, u)
        if fst.final[t] != math.inf:
            out.set_final(fst.start, min(out.final[fst.start], wc + fst.final[t]))

    out.connect()
    return out


def split_high_degree(fst: StdFst, max_out: int, eps_fan: int = 16) -> StdFst:
    """Cap per-state emitting out-degree at max_out by fanning overflow arcs
    onto virtual states connected with zero-cost eps arcs in a balanced
    TREE (fan-out `eps_fan`), so the eps-closure depth added per split is
    O(log_fan(degree)) — NOT O(degree).

    The round-4 version chained parts linearly: a 600-arc LM hub produced a
    119-deep eps chain, silently exceeding both the decoder's closure-round
    bound and the load-time closure iteration cap, and decode lost paths
    (caught by the 600-word WER corpus, tests/test_wer_bigvocab.py).

    The decoder's eps closure activates virtual states in the same frame
    their parent enters the frontier, so the next emitting expansion covers
    all arcs.  (Requires the decoder's eps phase, or a subsequent
    remove_epsilons call — which handles the tree exactly.)
    """
    out = StdFst()
    out.add_states(fst.num_states)
    out.set_start(fst.start)
    for s in range(fst.num_states):
        if fst.final[s] != math.inf:
            out.set_final(s, fst.final[s])
    for s in range(fst.num_states):
        em = [a for a in fst.arcs[s] if a[0] != EPSILON]
        eps = [a for a in fst.arcs[s] if a[0] == EPSILON]
        for il, ol, w, ns in eps:
            out.add_arc(s, il, ol, w, ns)
        if len(em) <= max_out:
            for il, ol, w, ns in em:
                out.add_arc(s, il, ol, w, ns)
            continue
        # leaves: virtual states carrying up to max_out emitting arcs each
        level = []
        for i in range(0, len(em), max_out):
            leaf = out.add_state()
            for il, ol, w, ns in em[i: i + max_out]:
                out.add_arc(leaf, il, ol, w, ns)
            level.append(leaf)
        # internal tree levels: fan eps_fan children per parent
        while len(level) > eps_fan:
            nxt_level = []
            for i in range(0, len(level), eps_fan):
                parent = out.add_state()
                for child in level[i: i + eps_fan]:
                    out.add_arc(parent, EPSILON, EPSILON, 0.0, child)
                nxt_level.append(parent)
            level = nxt_level
        for child in level:
            out.add_arc(s, EPSILON, EPSILON, 0.0, child)
    return out
