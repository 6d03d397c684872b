"""Word-error-rate scoring: Levenshtein alignment over word sequences.

Copy of `vosk_tpu/utils/wer.py` (pure Python), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

The reference scores WER through Kaldi's compute-wer / local/score.sh
(training/run.sh:80-95, training/local/score.sh); results in
training/RESULTS.txt.  This is the same metric: per-corpus
(S + D + I) / N over minimum-edit-distance alignments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class WerCounts:
    subs: int = 0
    dels: int = 0
    ins: int = 0
    ref_words: int = 0
    sentences: int = 0
    wrong_sentences: int = 0

    @property
    def errors(self) -> int:
        return self.subs + self.dels + self.ins

    @property
    def wer(self) -> float:
        return self.errors / max(self.ref_words, 1)

    @property
    def ser(self) -> float:
        return self.wrong_sentences / max(self.sentences, 1)

    def add(self, other: "WerCounts") -> None:
        self.subs += other.subs
        self.dels += other.dels
        self.ins += other.ins
        self.ref_words += other.ref_words
        self.sentences += other.sentences
        self.wrong_sentences += other.wrong_sentences

    def as_dict(self) -> Dict:
        return {
            "wer": round(self.wer, 4),
            "ser": round(self.ser, 4),
            "errors": self.errors,
            "subs": self.subs,
            "dels": self.dels,
            "ins": self.ins,
            "ref_words": self.ref_words,
            "sentences": self.sentences,
        }


def align(ref: Sequence[str], hyp: Sequence[str]) -> WerCounts:
    """Minimum-edit-distance alignment counts for one sentence (unit costs,
    the Kaldi compute-wer convention)."""
    R, H = len(ref), len(hyp)
    # dp over (dist, dels+ins, subs, dels, ins): equal-distance ties prefer
    # FEWER del/ins (i.e. substitution alignments), matching compute-wer
    INF = 1 << 30
    prev = [(j, j, 0, 0, j) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, i, 0, i, 0)] + [(INF, 0, 0, 0, 0)] * H
        ri = ref[i - 1]
        for j in range(1, H + 1):
            d_sub = prev[j - 1]
            e = 0 if ri == hyp[j - 1] else 1
            cand = [
                (d_sub[0] + e, d_sub[1], d_sub[2] + e, d_sub[3], d_sub[4]),
                (prev[j][0] + 1, prev[j][1] + 1, prev[j][2],
                 prev[j][3] + 1, prev[j][4]),
                (cur[j - 1][0] + 1, cur[j - 1][1] + 1, cur[j - 1][2],
                 cur[j - 1][3], cur[j - 1][4] + 1),
            ]
            cur[j] = min(cand)
        prev = cur
    d, _, s, dl, ins = prev[H]
    return WerCounts(
        subs=s, dels=dl, ins=ins, ref_words=R,
        sentences=1, wrong_sentences=1 if d > 0 else 0,
    )


def score_corpus(
    refs: Sequence[Sequence[str]], hyps: Sequence[Sequence[str]]
) -> WerCounts:
    """Aggregate WER over a corpus of (ref, hyp) word-sequence pairs."""
    if len(refs) != len(hyps):
        raise ValueError("refs and hyps must have equal length")
    total = WerCounts()
    for r, h in zip(refs, hyps):
        total.add(align(list(r), list(h)))
    return total


def wer(refs, hyps) -> float:
    return score_corpus(refs, hyps).wer
