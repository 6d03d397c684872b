"""Kaldi binary const-ARPA LM (`G.carpa`) — reader, builder, writer, and a
deterministic scoring adapter.

Copy of `vosk_tpu/io/kaldi_carpa.py` (host code; tests/test_torch_rescoring.py
holds it to its source, files byte for byte).  The reference loads this with
`ReadKaldiObject(carpa_rxfilename_, &const_arpa_)` (src/model.cc:308-314)
and rescores lattices through `ConstArpaLmDeterministicFst`
(recognizer.cc:680-693).  The format is Kaldi's `lm/const-arpa-lm.{h,cc}`
memory image:

  \\0B                                  Kaldi binary-mode marker
  <ConstArpaLm>                         token
  WriteBasicType int32: bos_symbol, eos_symbol, unk_symbol, ngram_order
  WriteBasicType int32: num_words, overflow_buffer_size
  WriteBasicType int64: lm_states_size
  raw int32[lm_states_size]             the LmState arena
  raw int32[num_words]                  unigram_states (arena index or -1)
  raw int32[overflow_buffer_size]       overflow pointers (64-bit addressing
                                        for >8 GB arenas; not supported here)

LmState arena entry at index `a` for n-gram history h:
  [a+0]  float32 bitcast: logprob(h)        (natural log, like Kaldi)
  [a+1]  float32 bitcast: backoff logprob of h
  [a+2]  int32: num_children
  [a+3+2i], [a+4+2i]: (word, info) pairs sorted by word, where
     info <  0  -> leaf n-gram: info is the float32 bitcast of its logprob
     info >= 0  -> arena index of the child LmState

A full n-gram is a leaf iff it has no continuations and no backoff weight,
or is of the highest order.

The port's builder collects the unigram states with one set where the
source rebuilds a set per unigram (quadratic in the vocabulary; minutes at
100k words); the arena it writes is the same.  `ConstArpaLm.scored` counts
score and final-cost lookups.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..graph.fst import SymbolTable
from .kaldiio import BinaryReader, BinaryWriter, KaldiReadError

LOG10 = math.log(10.0)


class ConstArpaLm:
    """Array-backed backoff LM with the BackoffLm scoring interface
    (score/final_cost/initial_state) used by lattice rescoring."""

    def __init__(self, bos: int, eos: int, unk: int, order: int,
                 num_words: int, lm_states: np.ndarray,
                 unigram_states: np.ndarray):
        self.bos = int(bos)
        self.eos = int(eos)
        self.unk = int(unk)
        self.order = int(order)
        self.num_words = int(num_words)
        self.lm_states = np.asarray(lm_states, np.int32)
        self.unigram_states = np.asarray(unigram_states, np.int32)
        self._f32 = self.lm_states.view(np.float32)
        self.scored = 0

    def _find_child(self, st: int, word: int) -> Optional[int]:
        """Returns the child `info` word for (state st, word), or None."""
        n = int(self.lm_states[st + 2])
        if n == 0:
            return None
        words = self.lm_states[st + 3: st + 3 + 2 * n: 2]
        i = int(np.searchsorted(words, word))
        if i < n and int(words[i]) == word:
            return int(self.lm_states[st + 4 + 2 * i])
        return None

    def _state_for(self, hist: Tuple[int, ...]) -> Optional[int]:
        if not hist:
            return None
        w0 = hist[0]
        if not (0 <= w0 < self.num_words):
            return None
        st = int(self.unigram_states[w0])
        if st < 0:
            return None
        for w in hist[1:]:
            info = self._find_child(st, w)
            if info is None or info < 0:
                return None
            st = info
        return st

    def _logprob(self, word: int, hist: Tuple[int, ...]) -> float:
        """Natural-log probability with standard backoff recursion
        (ConstArpaLm::GetNgramLogprobRecurse)."""
        if hist:
            st = self._state_for(hist)
            if st is not None:
                info = self._find_child(st, word)
                if info is not None:
                    if info < 0:  # inline leaf: float bits
                        return float(struct.unpack("<f", struct.pack("<i", info))[0])
                    return float(self._f32[info])
            backoff = 0.0
            if st is not None:
                backoff = float(self._f32[st + 1])
            return backoff + self._logprob(word, hist[1:])
        # unigram
        if 0 <= word < self.num_words and int(self.unigram_states[word]) >= 0:
            return float(self._f32[int(self.unigram_states[word])])
        if 0 <= self.unk < self.num_words and int(self.unigram_states[self.unk]) >= 0:
            return float(self._f32[int(self.unigram_states[self.unk])])
        return -20.0  # matches BackoffLm's OOV fallback cost

    def initial_state(self) -> Tuple[int, ...]:
        return (self.bos,) if self.order > 1 else ()

    def _shrink(self, hist: Tuple[int, ...]) -> Tuple[int, ...]:
        while hist and self._state_for(hist) is None:
            hist = hist[1:]
        return hist

    def score(self, state: Tuple[int, ...], word: int) -> Tuple[float, Tuple[int, ...]]:
        """(tropical cost = -ln p, next history state)."""
        self.scored += 1
        cost = -self._logprob(word, state)
        ns = (state + (word,))[-(self.order - 1):] if self.order > 1 else ()
        return cost, self._shrink(ns)

    def final_cost(self, state: Tuple[int, ...]) -> float:
        self.scored += 1
        return -self._logprob(self.eos, state)


def read_carpa(path) -> ConstArpaLm:
    """Read a Kaldi binary G.carpa (layout documented in the module
    docstring).  Text-mode carpa files are not produced by Kaldi tooling and
    are rejected."""
    with open(path, "rb") as f:
        marker = f.read(2)
        if marker != b"\x00B":
            raise KaldiReadError(
                f"{path}: not a Kaldi binary file (G.carpa is written in binary mode)"
            )
        r = BinaryReader(f)
        r.expect_token("<ConstArpaLm>")
        bos = r.read_basic_int()
        eos = r.read_basic_int()
        unk = r.read_basic_int()
        order = r.read_basic_int()
        num_words = r.read_basic_int()
        overflow_size = r.read_basic_int()
        lm_states_size = r.read_basic_int()
        if not (1 <= order <= 12) or num_words < 0 or lm_states_size < 0:
            raise KaldiReadError(
                f"{path}: implausible ConstArpaLm header (order={order}, "
                f"num_words={num_words}, lm_states={lm_states_size}) — "
                "layout mismatch?"
            )
        if overflow_size > 0:
            raise KaldiReadError(
                f"{path}: ConstArpaLm uses the 64-bit overflow buffer "
                "(arena > 2^31 ints); not supported by this reader"
            )
        lm_states = np.frombuffer(f.read(4 * lm_states_size), dtype="<i4",
                                  count=lm_states_size)
        unigram = np.frombuffer(f.read(4 * num_words), dtype="<i4", count=num_words)
        return ConstArpaLm(bos, eos, unk, order, num_words, lm_states, unigram)


def write_carpa(lm: ConstArpaLm, path) -> None:
    with open(path, "wb") as f:
        f.write(b"\x00B")
        w = BinaryWriter(f)
        w.write_token("<ConstArpaLm>")
        for v in (lm.bos, lm.eos, lm.unk, lm.order, lm.num_words, 0):
            w.write_basic_int(v)
        # lm_states_size is an int64 in Kaldi (arenas can exceed 2^31 bytes)
        f.write(bytes([8]) + struct.pack("<q", int(len(lm.lm_states))))
        f.write(np.asarray(lm.lm_states, "<i4").tobytes())
        f.write(np.asarray(lm.unigram_states, "<i4").tobytes())


def build_carpa_from_arpa(arpa_path, words: SymbolTable, bos: str = "<s>",
                          eos: str = "</s>", unk: str = "<unk>") -> ConstArpaLm:
    """Compile ARPA text into the const-ARPA arena (ConstArpaLmBuilder
    semantics): probabilities natural-log, leaves inlined, children sorted.

    Word ids come from `words` (the graph's words.txt); <s>/</s> must be
    present there or are assigned virtual ids past the end, matching how
    Kaldi builds G.carpa with --bos-symbol/--eos-symbol ids.
    """
    n = len(words)
    ids: Dict[str, int] = {}
    for sym, fallback in ((bos, n), (eos, n + 1), (unk, -1)):
        i = words.find(sym)
        ids[sym] = i if i > 0 else fallback
    num_words = max(n, ids[bos] + 1, ids[eos] + 1)

    def wid(tok: str) -> Optional[int]:
        if tok in (bos, eos, unk):
            i = ids[tok]
            return i if i >= 0 else None
        i = words.find(tok)
        return i if i > 0 else None

    # parse ARPA: ngram -> (logprob_ln, backoff_ln)
    grams: Dict[Tuple[int, ...], Tuple[float, float]] = {}
    order = 1
    cur = 0
    section = None
    with open(arpa_path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("\\data"):
                section = "data"
                continue
            if line.startswith("\\end"):
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                cur = int(line[1:line.index("-")])
                order = max(order, cur)
                section = "ngrams"
                continue
            if section != "ngrams" or cur == 0:
                continue
            parts = line.split()
            if len(parts) < cur + 1:
                continue
            logp = float(parts[0]) * LOG10
            toks = parts[1: 1 + cur]
            back = float(parts[1 + cur]) * LOG10 if len(parts) > 1 + cur else 0.0
            seq = tuple(wid(t) for t in toks)
            if any(i is None for i in seq):
                continue
            grams[seq] = (logp, back)

    # ensure every proper prefix of a gram exists (Kaldi requires ARPA
    # consistency; fill holes with prob 0 so the trie stays walkable)
    for seq in list(grams):
        for k in range(1, len(seq)):
            grams.setdefault(seq[:k], (-99.0 * LOG10, 0.0))

    children: Dict[Tuple[int, ...], list] = {}
    for seq in grams:
        if len(seq) > 1:
            children.setdefault(seq[:-1], []).append(seq[-1])

    # states = grams that need an arena entry
    def is_leaf(seq):
        return len(seq) == order or (seq not in children and grams[seq][1] == 0.0)

    state_seqs = [s for s in sorted(grams) if not is_leaf(s)]
    # unigrams always get a state (unigram_states_ points at them)
    have = set(state_seqs)
    state_seqs += [s for s in sorted(grams) if len(s) == 1 and s not in have]
    state_seqs.sort()
    sizes = {s: 3 + 2 * len(children.get(s, ())) for s in state_seqs}
    addr: Dict[Tuple[int, ...], int] = {}
    pos = 0
    for s in state_seqs:
        addr[s] = pos
        pos += sizes[s]

    arena = np.zeros(pos, np.int32)
    fview = arena.view(np.float32)

    def f2i(x: float) -> int:
        return struct.unpack("<i", struct.pack("<f", np.float32(x)))[0]

    for s in state_seqs:
        a = addr[s]
        logp, back = grams[s]
        fview[a] = np.float32(logp)
        fview[a + 1] = np.float32(back)
        kids = sorted(children.get(s, ()))
        arena[a + 2] = len(kids)
        for i, wd in enumerate(kids):
            arena[a + 3 + 2 * i] = wd
            child = s + (wd,)
            if child in addr:
                arena[a + 4 + 2 * i] = addr[child]
            else:
                lp = grams[child][0]
                if lp >= 0.0:  # keep the sign-bit discriminator valid
                    lp = -1e-7
                arena[a + 4 + 2 * i] = f2i(lp)

    unigram = np.full(num_words, -1, np.int32)
    for s in state_seqs:
        if len(s) == 1 and 0 <= s[0] < num_words:
            unigram[s[0]] = addr[s]

    return ConstArpaLm(ids[bos], ids[eos], ids[unk], order, num_words, arena, unigram)
