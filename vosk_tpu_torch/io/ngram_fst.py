"""OpenFST NGramFst (`Gr.fst` of split-graph vosk models) — best-effort
reader.

The reference registers fst/extensions/ngram/ngram-fst.h so that
`fst::StdFst::Read` can load "ngram"-type Gr.fst files
(reference src/model.cc:27-32,283).  NGramFst is a compacted
read-only representation of a backoff n-gram word acceptor: a LOUDS-encoded
trie of REVERSED contexts, with per-state futures (outgoing words) and
probabilities.

Layout as reconstructed from openfst ngram-fst.h (after the standard
FstHeader, which the caller has already consumed):

  uint64 num_states, num_futures, num_final
  uint64[ceil((2*num_states+1)/64)]                context LOUDS bits
  uint64[ceil((num_states+num_futures+1)/64)]      future unary-degree bits
  uint64[ceil((num_states+1)/64)]                  final bitvector
  int32[num_states]                                context_words (edge label
                                                   into each trie node)
  int32[num_futures]                               future_words
  <8-byte alignment padding>
  float32[num_states]                              backoff weights
  float32[num_final]                               final weights
  float32[num_futures]                             future (arc) weights

LOUDS: nodes in BFS order, "1^degree 0" per node with a "10" super-root
prefix; bit k = (word[k//64] >> (k%64)) & 1.  Node 0 is the root (empty /
unigram context).  state semantics:
  - backoff arc: (label 0, backoff_[s]) to the trie PARENT (dropping the
    oldest history word = LOUDS parent, since contexts are reversed)
  - future arc (s, w): weight future_probs, destination = deepest trie node
    reached from the ROOT along labels (w, ctx(s)[0], ctx(s)[1], ...)

Every structural invariant is checked; a mismatch raises KaldiReadError
with a conversion hint, so a layout drift in real files fails loudly
instead of mis-decoding.

Copy of `vosk_tpu/io/ngram_fst.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np

from .kaldiio import KaldiReadError

_CONVERT_HINT = (
    " — if this Gr.fst came from a real model, convert it with OpenFST: "
    "`fstconvert --fst_type=const Gr.fst Gr.const.fst`"
)


class _Bits:
    """LSB-first bitvector over little-endian uint64 words with rank/select."""

    def __init__(self, words: np.ndarray, nbits: int):
        b = np.unpackbits(
            words.view(np.uint8), bitorder="little"
        )[:nbits].astype(np.int8)
        self.bits = b
        self.nbits = nbits
        self._pos1 = np.flatnonzero(b)          # select1
        self._pos0 = np.flatnonzero(b == 0)     # select0
        self._rank1 = np.cumsum(b)              # rank1(k) = ones in [0, k]

    def select1(self, i: int) -> int:
        return int(self._pos1[i])

    def select0(self, i: int) -> int:
        return int(self._pos0[i])

    def rank1(self, k: int) -> int:  # ones in [0, k] inclusive
        return int(self._rank1[k]) if k >= 0 else 0

    @property
    def num_ones(self) -> int:
        return len(self._pos1)


def words_for_bits(nbits: int) -> int:
    return (nbits + 63) // 64


def read_ngram_data(f, header_start: int):
    """Parse the NGramFst data block (stream positioned just after the
    FstHeader).  Returns (start, finals, arcs_per_state) like a RawFst."""
    raw = f.read(24)
    if len(raw) < 24:
        raise KaldiReadError("ngram fst: truncated counts" + _CONVERT_HINT)
    num_states, num_futures, num_final = struct.unpack("<QQQ", raw)
    if not (0 < num_states < (1 << 40)) or num_final > num_states + 1:
        raise KaldiReadError(
            f"ngram fst: implausible counts states={num_states} "
            f"futures={num_futures} finals={num_final}" + _CONVERT_HINT
        )

    def read_u64s(nbits):
        n = words_for_bits(nbits)
        d = f.read(8 * n)
        if len(d) < 8 * n:
            raise KaldiReadError("ngram fst: truncated bitmap" + _CONVERT_HINT)
        return np.frombuffer(d, "<u8")

    context = _Bits(read_u64s(2 * num_states + 1), 2 * num_states + 1)
    future = _Bits(
        read_u64s(num_states + num_futures + 1), num_states + num_futures + 1
    )
    final = _Bits(read_u64s(num_states + 1), num_states + 1)

    context_words = np.frombuffer(f.read(4 * num_states), "<i4")
    future_words = np.frombuffer(f.read(4 * num_futures), "<i4")
    # 8-byte alignment of the float sections (counts are from data start)
    consumed = (
        24
        + 8 * (words_for_bits(2 * num_states + 1)
               + words_for_bits(num_states + num_futures + 1)
               + words_for_bits(num_states + 1))
        + 4 * (num_states + num_futures)
    )
    pad = (-consumed) % 8
    if pad:
        f.read(pad)
    backoff = np.frombuffer(f.read(4 * num_states), "<f4")
    final_probs = np.frombuffer(f.read(4 * num_final), "<f4")
    future_probs = np.frombuffer(f.read(4 * num_futures), "<f4")
    if len(backoff) < num_states or len(future_probs) < num_futures:
        raise KaldiReadError("ngram fst: truncated weights" + _CONVERT_HINT)

    # ---- structural validation (fail loudly on layout drift)
    if context.num_ones != num_states:
        raise KaldiReadError(
            f"ngram fst: LOUDS ones {context.num_ones} != states "
            f"{num_states}" + _CONVERT_HINT
        )
    if future.num_ones != num_futures:
        raise KaldiReadError(
            f"ngram fst: future ones {future.num_ones} != futures "
            f"{num_futures}" + _CONVERT_HINT
        )
    if final.num_ones != num_final:
        raise KaldiReadError(
            f"ngram fst: final ones {final.num_ones} != finals "
            f"{num_final}" + _CONVERT_HINT
        )
    if not np.all(np.isfinite(backoff)) or not np.all(
        np.isfinite(future_probs)
    ):
        raise KaldiReadError("ngram fst: non-finite weights" + _CONVERT_HINT)

    # ---- LOUDS navigation
    # node i (0-based, BFS order): its children start after the 0-bit that
    # terminates node i's degree block.  With the "10" super-root prefix,
    # node i's block starts at select0(i)+1; children are consecutive
    # 1-bits; child node ids are rank1 over the bit positions.
    def children(i) -> range:
        lo = context.select0(i) + 1
        hi = context.select0(i + 1)
        # child ids: ranks of the 1-bits in [lo, hi)
        first = context.rank1(lo - 1)  # ones before lo
        return range(first, first + (hi - lo))

    parent = np.zeros(num_states, np.int64)
    for i in range(num_states):
        for c in children(i):
            if c >= num_states:
                raise KaldiReadError(
                    "ngram fst: LOUDS child out of range" + _CONVERT_HINT
                )
            parent[c] = i

    # trie child lookup maps
    child_map: List[dict] = [dict() for _ in range(num_states)]
    for i in range(num_states):
        for c in children(i):
            child_map[i][int(context_words[c])] = c

    # context path (labels from node up to root, most-recent first)
    def ctx_path(s) -> List[int]:
        out = []
        while s != 0:
            out.append(int(context_words[s]))
            s = int(parent[s])
        return out

    def target(s, w) -> int:
        labels = [w] + ctx_path(s)
        node = 0
        for lb in labels:
            nxt = child_map[node].get(lb)
            if nxt is None:
                break
            node = nxt
        return node

    # futures of state s occupy unary block s of the future bitvector
    def futures(s) -> range:
        lo = future.select0(s) + 1
        hi = future.select0(s + 1)
        first = future.rank1(lo - 1)
        return range(first, first + (hi - lo))

    finals = np.full(num_states, np.inf, np.float32)
    fidx = 0
    for s in range(num_states):
        if final.bits[s]:
            finals[s] = final_probs[fidx]
            fidx += 1

    arcs_per_state: List[np.ndarray] = []
    f2i = lambda x: struct.unpack("<i", struct.pack("<f", x))[0]
    for s in range(num_states):
        rows = []
        if s != 0:  # backoff arc to the trie parent
            rows.append((0, 0, f2i(float(backoff[s])), int(parent[s])))
        for k in futures(s):
            w = int(future_words[k])
            rows.append((w, w, f2i(float(future_probs[k])), target(s, w)))
        arcs_per_state.append(np.asarray(rows, "<i4").reshape(-1, 4))

    start = header_start if 0 <= header_start < num_states else 0
    return start, finals, arcs_per_state
