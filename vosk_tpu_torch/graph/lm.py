"""Runtime n-gram language-model estimation for grammar-constrained decoding.

Copy of `vosk_tpu/graph/lm.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

Behavioral contract from the reference's `LanguageModelEstimator`
(src/language_model.cc, invoked for grammar recognizers at
src/recognizer.cc:65-92 with ngram_order=2, discount=0.5): absolute
discounting with hard backoff — every n-gram observed with count c in a state
with total count N gets probability c*discount/N; a backoff arc with cost
-log(1-discount) points to the next-shorter history; label 0 counts terminate
sentences (become final weights).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from .fst import StdFst


@dataclasses.dataclass
class LanguageModelOptions:
    ngram_order: int = 2
    discount: float = 0.5


class LanguageModelEstimator:
    def __init__(self, opts: LanguageModelOptions = LanguageModelOptions()):
        assert opts.ngram_order >= 2, "--ngram-order must be >= 2"
        self.opts = opts
        self._counts: Dict[Tuple[int, ...], Dict[int, int]] = {}
        self._totals: Dict[Tuple[int, ...], int] = {}

    def add_counts(self, sentence: List[int]) -> None:
        order = self.opts.ngram_order
        history: Tuple[int, ...] = ()
        for w in sentence:
            assert w != 0
            self._increment(history, w)
            history = (history + (w,))[-(order - 1) :]
        self._increment(history, 0)  # end-of-sentence

    def _increment(self, history: Tuple[int, ...], w: int) -> None:
        # create all backoff histories so backoff targets exist
        h = history
        while True:
            self._counts.setdefault(h, {})
            self._totals.setdefault(h, 0)
            if not h:
                break
            h = h[1:]
        self._counts[history][w] = self._counts[history].get(w, 0) + 1
        self._totals[history] += 1

    def estimate(self) -> StdFst:
        """Emit the backoff-bigram/ngram acceptor (word labels on arcs)."""
        d = self.opts.discount
        active = [h for h, n in self._totals.items() if n > 0]
        state_of = {h: i for i, h in enumerate(sorted(active, key=lambda h: (len(h), h)))}

        def nonzero_state(hist: Tuple[int, ...]) -> int:
            h = hist
            while h not in state_of:
                if not h:
                    raise RuntimeError("no unigram state")
                h = h[1:]
            return state_of[h]

        fst = StdFst()
        fst.add_states(len(state_of))
        fst.set_start(nonzero_state(()))
        for h, s in state_of.items():
            total = self._totals[h]
            for w, c in self._counts[h].items():
                logprob = math.log(c * d / total)
                if w == 0:
                    fst.set_final(s, -logprob)
                else:
                    nh = (h + (w,))[-(self.opts.ngram_order - 1) :]
                    fst.add_arc(s, w, w, -logprob, nonzero_state(nh))
            if h:  # backoff arc to shorter history
                fst.add_arc(s, 0, 0, -math.log(1.0 - d), nonzero_state(h[1:]))
        fst.connect()
        fst.arcsort()
        return fst


def grammar_to_fst(
    phrases: List[str], word_ids, ngram_order: int = 2, discount: float = 0.5
):
    """JSON-phrase-list grammar -> G fst, mirroring the grammar recognizer
    ctor (reference recognizer.cc:57-92).  `word_ids` is a callable
    word -> id (returning -1 for OOV, which is skipped with a warning)."""
    from ..utils.logging import log_warn

    est = LanguageModelEstimator(LanguageModelOptions(ngram_order, discount))
    for phrase in phrases:
        sent = []
        for token in phrase.split(" "):
            i = word_ids(token)
            if i is None or i < 0:
                log_warn(f"Ignoring word missing in vocabulary: '{token}'")
            elif i != 0:
                sent.append(i)
        est.add_counts(sent)
    return est.estimate()
