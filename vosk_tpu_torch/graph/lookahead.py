"""Split-graph (HCLr / Gr) support.

Lookahead models ship the decoding graph in two parts: `HCLr.fst`
(HMM+context+lexicon, tid ilabels, word olabels, plus disambiguation
symbols listed in `disambig_tid.int`) and `Gr.fst` (the word-level grammar
acceptor).  The reference composes them lazily with OpenFST's lookahead
matchers (`LookaheadComposeFst(hcl, g, disambig)`, reference
src/recognizer.cc:33,94,120; loading at model.cc:278-286).

The decoder needs a static arc table, so the composition happens eagerly
at load time: standard tropical composition (graph/builder.py), then the
disambiguation ilabels are replaced by epsilon — exactly what
LookaheadComposeFst's RemoveSomeInputSymbols wrapper does lazily.  The same
entry point powers runtime grammars on split-graph models (a phrase-list G
replaces Gr, reference recognizer.cc:60-95).

Copy of `vosk_tpu/graph/lookahead.py` (host only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List

from .builder import compose
from .fst import EPSILON, StdFst


def read_disambig_tids(path) -> List[int]:
    """disambig_tid.int: whitespace-separated transition-id-domain labels of
    the disambiguation symbols present in HCLr's input alphabet
    (ReadIntegerVectorSimple at reference model.cc:285)."""
    toks = Path(path).read_text().split()
    return [int(t) for t in toks]


def strip_input_symbols(fst: StdFst, labels: Iterable[int]) -> StdFst:
    """Replace the given ilabels with epsilon, in place (the role of
    fst::RemoveSomeInputSymbols inside LookaheadComposeFst)."""
    drop = set(int(x) for x in labels)
    if not drop:
        return fst
    for s in range(fst.num_states):
        fst.arcs[s] = [
            (EPSILON if il in drop else il, ol, w, ns)
            for (il, ol, w, ns) in fst.arcs[s]
        ]
    return fst


def lookahead_compose(hcl: StdFst, g: StdFst, disambig: Iterable[int]) -> StdFst:
    """HCLr ∘ Gr with disambiguation-symbol removal; eager equivalent of
    the reference's LookaheadComposeFst."""
    out = compose(hcl, g)
    if out.num_states == 0:
        raise ValueError(
            "HCLr ∘ Gr composition is empty — mismatched word alphabets?"
        )
    return strip_input_symbols(out, disambig)


def prepare_decode_fst(fst: StdFst, id2pdf, max_out: int = 16):
    """Shared graph preparation for loaded/composed Kaldi graphs: epsilon
    removal, out-degree cap (for the padded arc layout), tid->pdf mapping,
    CSR flattening.  Returns a DecodingGraph."""
    from .fst import flatten_fst
    from .optimize import remove_epsilons, split_high_degree

    fst = remove_epsilons(fst)
    max_deg = max(
        (sum(1 for a in arcs if a[0] != EPSILON) for arcs in fst.arcs),
        default=0,
    )
    if max_deg > max_out:
        fst = split_high_degree(fst, max_out)
    return flatten_fst(fst, ilabel_to_pdf=id2pdf)
