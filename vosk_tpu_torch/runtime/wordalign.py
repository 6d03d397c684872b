"""Word-boundary realignment of best-path/lattice word spans.

Copy of `vosk_tpu/runtime/wordalign.py` (numpy only), kept in the port
because nothing under `vosk_tpu` imports without jax;
tests/test_torch_copies.py holds it to its source.

The reference realigns lattices phone->word with `WordAlignLattice` using
`word_boundary.int` (src/model.cc:302-306, recognizer.cc:435,566,752): each
phone is typed begin/end/internal/singleton/nonword, and word time spans
are the frame ranges of their phone groups.  This module applies the same
typing to the decoder's per-frame pdf alignment; when the alignment is
inconsistent with the typing (e.g. non-positional phones), callers keep
the olabel-emission spans.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

BEGIN = {"begin", "wbegin"}
END = {"end", "wend"}
INTERNAL = {"internal", "winternal"}
SINGLETON = {"singleton", "wbegin_and_wend", "begin_and_end"}
NONWORD = {"nonword"}


def word_spans(
    pdfs: Sequence[int],
    phone_of_pdf,
    word_boundary: Dict[int, str],
) -> Optional[List[Tuple[int, int]]]:
    """Segment a per-frame pdf alignment into word (start, end) frame spans
    using phone boundary types.  Returns None when the alignment doesn't
    parse (caller falls back to emission-based spans)."""
    n_pdf = len(phone_of_pdf)
    spans: List[Tuple[int, int]] = []
    inside = False
    start = 0
    prev_phone = -1
    for f, p in enumerate(pdfs):
        if p < 0 or p >= n_pdf:
            return None
        ph = int(phone_of_pdf[p])
        new_run = ph != prev_phone
        prev_phone = ph
        ty = word_boundary.get(ph, "")
        if ty in NONWORD or ty == "":
            if inside:
                return None
            continue
        if ty in BEGIN:
            if new_run:
                if inside:
                    return None
                inside = True
                start = f
        elif ty in INTERNAL:
            if not inside:
                return None
        elif ty in END:
            if not inside:
                return None
            # span closes when the end-phone run finishes
            nxt = pdfs[f + 1] if f + 1 < len(pdfs) else -1
            nxt_ph = int(phone_of_pdf[nxt]) if 0 <= nxt < n_pdf else -1
            if nxt_ph != ph:
                spans.append((start, f + 1))
                inside = False
        elif ty in SINGLETON:
            if new_run:
                if inside:
                    return None
                inside = True
                start = f
            nxt = pdfs[f + 1] if f + 1 < len(pdfs) else -1
            nxt_ph = int(phone_of_pdf[nxt]) if 0 <= nxt < n_pdf else -1
            if nxt_ph != ph:
                spans.append((start, f + 1))
                inside = False
        else:
            return None
    if inside:
        spans.append((start, len(pdfs)))  # truncated final word
    return spans


def realign_items(
    items: List[Tuple[int, int, int, float]],
    pdfs: Sequence[int],
    phone_of_pdf,
    word_boundary: Optional[Dict[int, str]],
) -> List[Tuple[int, int, int, float]]:
    """Replace word (f0, f1) spans with word-boundary-aligned spans when the
    typing parses and yields exactly one span per word."""
    if not word_boundary or not items:
        return items
    spans = word_spans(pdfs, phone_of_pdf, word_boundary)
    if spans is None or len(spans) != len(items):
        return items
    return [
        (wid, s0, s1, conf)
        for ((wid, _f0, _f1, conf), (s0, s1)) in zip(items, spans)
    ]
