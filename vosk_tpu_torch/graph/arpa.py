"""ARPA backoff language models + deterministic on-demand scoring.

Copy of `vosk_tpu/graph/arpa.py` (host code; tests/test_torch_rescoring.py
holds it to its source).  Role of the reference's big-LM rescoring pair
(src/model.cc:308-314 loads rescore/G.fst to *subtract* and G.carpa to
*add*; applied at src/recognizer.cc:680-693).  `BackoffLm` reads standard
ARPA text (the format G.carpa is compiled from) into a trie and
`BackoffLm.score(state, word)` walks it like `ConstArpaLmDeterministicFst`;
`FstLm` gives the same interface over a word-level StdFst (the graph's own
G, used for subtraction).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .fst import EPSILON, StdFst, SymbolTable

LOG10 = math.log(10.0)


class BackoffLm:
    """n-gram backoff LM over word ids; costs in -ln (tropical)."""

    def __init__(self):
        # history tuple -> {word: cost}; backoff cost per history
        self.ngrams: Dict[Tuple[int, ...], Dict[int, float]] = {}
        self.backoffs: Dict[Tuple[int, ...], float] = {}
        self.order = 1
        self.bos = -1  # <s> id
        self.eos = -2  # </s> id
        self.unk = -3  # <unk> id or -3 if absent

    @classmethod
    def read_arpa(cls, path, words: SymbolTable) -> "BackoffLm":
        """Parse ARPA text.  OOV words in the file are skipped (they can't
        appear in lattices).  <s>, </s>, <unk> get reserved internal ids."""
        lm = cls()
        special = {"<s>": lm.bos, "</s>": lm.eos, "<unk>": lm.unk, "<UNK>": lm.unk}

        def wid(tok: str) -> Optional[int]:
            if tok in special:
                return special[tok]
            i = words.find(tok)
            return i if i > 0 else None

        cur_order = 0
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            section = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\data"):
                    section = "data"
                    continue
                if line.startswith("\\end"):
                    break
                if line.endswith("-grams:") and line.startswith("\\"):
                    cur_order = int(line[1: line.index("-")])
                    lm.order = max(lm.order, cur_order)
                    section = "ngrams"
                    continue
                if section != "ngrams" or cur_order == 0:
                    continue
                parts = line.split()
                if len(parts) < cur_order + 1:
                    continue
                logp = float(parts[0])
                toks = parts[1: 1 + cur_order]
                back = float(parts[1 + cur_order]) if len(parts) > 1 + cur_order else 0.0
                ids = [wid(t) for t in toks]
                if any(i is None for i in ids):
                    continue
                hist, w = tuple(ids[:-1]), ids[-1]
                lm.ngrams.setdefault(hist, {})[w] = -logp * LOG10
                if back != 0.0:
                    lm.backoffs[tuple(ids)] = -back * LOG10
        return lm

    def initial_state(self) -> Tuple[int, ...]:
        # sentence-begin context; score() backs off harmlessly if the LM has
        # no <s>-conditioned n-grams
        return (self.bos,) if self.order > 1 else ()

    def score(self, state: Tuple[int, ...], word: int) -> Tuple[float, Tuple[int, ...]]:
        """(cost, next_state) with standard backoff."""
        hist = state
        backoff_cost = 0.0
        while True:
            entry = self.ngrams.get(hist)
            if entry is not None and word in entry:
                cost = backoff_cost + entry[word]
                ns = (hist + (word,))[-(self.order - 1):] if self.order > 1 else ()
                # shrink to a state that exists as a history or has backoff
                while ns and ns not in self.ngrams and ns not in self.backoffs:
                    ns = ns[1:]
                return cost, ns
            if not hist:
                # OOV under this LM: use <unk> if present, else big cost
                if entry is not None and self.unk in entry:
                    return backoff_cost + entry[self.unk], ()
                return backoff_cost + 20.0, ()
            backoff_cost += self.backoffs.get(hist, 0.0)
            hist = hist[1:]

    def final_cost(self, state: Tuple[int, ...]) -> float:
        cost, _ = self.score(state, self.eos)
        return cost


class FstLm:
    """Deterministic-backoff scoring over a word acceptor StdFst (the
    grammar/graph G with eps backoff arcs) — the subtraction side
    ('lm_to_subtract', reference recognizer.cc:175)."""

    def __init__(self, fst: StdFst):
        self.fst = fst
        # arc maps: state -> {ilabel: (cost, next)}, backoff: state -> (cost, next)
        self.trans: List[Dict[int, Tuple[float, int]]] = []
        self.backoff: List[Optional[Tuple[float, int]]] = []
        for s in range(fst.num_states):
            m: Dict[int, Tuple[float, int]] = {}
            bo = None
            for il, ol, w, ns in fst.arcs[s]:
                if il == EPSILON:
                    bo = (w, ns)
                elif il not in m or w < m[il][0]:
                    m[il] = (w, ns)
            self.trans.append(m)
            self.backoff.append(bo)

    def initial_state(self) -> int:
        return self.fst.start

    def score(self, state: int, word: int) -> Tuple[float, int]:
        cost = 0.0
        s = state
        hops = 0
        while True:
            e = self.trans[s].get(word)
            if e is not None:
                return cost + e[0], e[1]
            bo = self.backoff[s]
            if bo is None or hops > 100:
                return cost + 20.0, s
            cost += bo[0]
            s = bo[1]
            hops += 1

    def final_cost(self, state: int) -> float:
        cost = 0.0
        s = state
        hops = 0
        while True:
            if self.fst.final[s] != math.inf:
                return cost + self.fst.final[s]
            bo = self.backoff[s]
            if bo is None or hops > 100:
                return cost + 20.0
            cost += bo[0]
            s = bo[1]
            hops += 1
