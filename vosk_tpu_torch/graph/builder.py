"""Decoding-graph compilation for native models: lexicon + grammar/LM ->
HCLG-style graph with pdf ilabels.

Copy of `vosk_tpu/graph/builder.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

The reference consumes precompiled Kaldi HCLG.fst graphs (or composes
HCLr∘Gr at runtime, src/recognizer.cc:33,94).  Native vosk_tpu models compile
their graph at build (or runtime-grammar) time from:
  - a lexicon (word -> phone sequences),
  - a phone HMM topology (n emitting states per phone, self-loops),
  - a word-level acceptor G (n-gram LM from graph/lm.py, or any StdFst).

The output graph's emitting arcs carry ilabel = pdf+1 so it flattens with the
default identity ilabel_to_pdf map in graph/fst.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .fst import EPSILON, StdFst, SymbolTable, flatten_fst


@dataclasses.dataclass
class Topology:
    """Per-phone HMM: `states_per_phone` emitting states, each with a
    self-loop; pdfs assigned sequentially per (phone, state)."""

    states_per_phone: int = 1
    self_loop_prob: float = 0.5

    @property
    def self_loop_cost(self) -> float:
        return -math.log(self.self_loop_prob)

    @property
    def forward_cost(self) -> float:
        return -math.log(1.0 - self.self_loop_prob)


@dataclasses.dataclass
class Lexicon:
    words: SymbolTable              # word symbols; 0 = <eps>
    phones: SymbolTable             # phone symbols; 0 = <eps>
    prons: Dict[int, List[List[int]]]  # word id -> list of phone-id sequences
    silence_phone: int = 0          # 0 = no optional silence
    silence_cost: float = 0.7       # -log P(sil) between words
    no_silence_cost: float = 0.7
    # label_last: emit the word olabel on the LAST phone arc and share
    # pronunciation PREFIXES in a trie.  A flat per-word lexicon gives the
    # root a vocabulary-sized out-degree, which (a) defeats the dense
    # padded arc layout and (b) after load-time epsilon removal fans LM
    # backoff targets into ~vocab/M-degree states (r5 finding at the
    # 600-word corpus).  The trie keeps every state's out-degree at
    # O(#phones).  Word timing anchors then sit at word END; consumers
    # realign via word-boundary info / pdf alignment (the reference also
    # realigns, WordAlignLattice at recognizer.cc:435).
    label_last: bool = False


def make_lexicon_fst(lex: Lexicon) -> StdFst:
    """L: phones in, words out, with optional inter-word silence loop.

    label_last=False: per-word linear chains, olabel on the first arc
    (word anchors at word start — legacy layout).
    label_last=True: pronunciation-prefix trie, olabel on the last arc.
    """
    f = StdFst()
    root = f.add_state()
    f.set_start(root)
    f.set_final(root, 0.0)
    if lex.silence_phone:
        f.add_arc(root, lex.silence_phone, EPSILON, lex.silence_cost, root)
    if not lex.label_last:
        for wid, prons in lex.prons.items():
            for pron in prons:
                prev = root
                for i, p in enumerate(pron):
                    ol = wid if i == 0 else EPSILON
                    if i == len(pron) - 1:
                        f.add_arc(prev, p, ol, 0.0, root)
                    else:
                        s = f.add_state()
                        f.add_arc(prev, p, ol, 0.0, s)
                        prev = s
        return f
    # trie: one state per pronunciation prefix; final arcs (last phone,
    # word label) return to root.  Homophones become parallel final arcs.
    node: Dict[Tuple[int, ...], int] = {(): root}
    for wid, prons in lex.prons.items():
        for pron in prons:
            prefix: Tuple[int, ...] = ()
            for p in pron[:-1]:
                nxt = prefix + (int(p),)
                if nxt not in node:
                    s = f.add_state()
                    f.add_arc(node[prefix], p, EPSILON, 0.0, s)
                    node[nxt] = s
                prefix = nxt
            f.add_arc(node[prefix], pron[-1], wid, 0.0, root)
    return f


def compose(a: StdFst, b: StdFst) -> StdFst:
    """Compose a (x:y) with b (y:z) -> (x:z), tropical semiring.

    Epsilon handling: epsilon-sequencing approximation (a-output-eps moves and
    b-input-eps moves both allowed from every pair state).  This can duplicate
    paths relative to a filtered composition but preserves minimum path cost,
    which is all Viterbi decoding needs.
    """
    out = StdFst()
    state_map: Dict[Tuple[int, int], int] = {}
    stack: List[Tuple[int, int]] = []

    def get(sa: int, sb: int) -> int:
        key = (sa, sb)
        if key not in state_map:
            state_map[key] = out.add_state()
            stack.append(key)
        return state_map[key]

    if a.start < 0 or b.start < 0:
        return out
    start = get(a.start, b.start)
    out.set_start(start)
    while stack:
        sa, sb = stack.pop()
        s = state_map[(sa, sb)]
        fa, fb = a.final[sa], b.final[sb]
        if fa != math.inf and fb != math.inf:
            out.set_final(s, fa + fb)
        for il, ol, w, ns in a.arcs[sa]:
            if ol == EPSILON:
                out.add_arc(s, il, EPSILON, w, get(ns, sb))
            else:
                for il2, ol2, w2, ns2 in b.arcs[sb]:
                    if il2 == ol:
                        out.add_arc(s, il, ol2, w + w2, get(ns, ns2))
        for il2, ol2, w2, ns2 in b.arcs[sb]:
            if il2 == EPSILON:
                out.add_arc(s, EPSILON, ol2, w2, get(sa, ns2))
    out.connect()
    return out


def expand_hmm(lg: StdFst, topo: Topology, num_phones: int) -> Tuple[StdFst, Dict]:
    """Replace phone-labeled arcs with HMM state chains emitting pdf+1 labels.

    Returns (graph, info) where info maps pdfs: pdf_of[(phone, state)] and
    phone_of_pdf list (for silence/endpoint bookkeeping).
    """
    pdf_of: Dict[Tuple[int, int], int] = {}
    phone_of_pdf: List[int] = []
    for p in range(1, num_phones + 1):
        for k in range(topo.states_per_phone):
            pdf_of[(p, k)] = len(phone_of_pdf)
            phone_of_pdf.append(p)

    f = StdFst()
    f.add_states(lg.num_states)
    f.set_start(lg.start)
    for s in range(lg.num_states):
        if lg.final[s] != math.inf:
            f.set_final(s, lg.final[s])
    for s in range(lg.num_states):
        for il, ol, w, ns in lg.arcs[s]:
            if il == EPSILON:
                f.add_arc(s, EPSILON, ol, w, ns)
                continue
            prev = s
            ow = ol
            cost = w
            for k in range(topo.states_per_phone):
                m = f.add_state()
                f.add_arc(prev, pdf_of[(il, k)] + 1, ow, cost + topo.forward_cost, m)
                f.add_arc(m, pdf_of[(il, k)] + 1, EPSILON, topo.self_loop_cost, m)
                prev, ow, cost = m, EPSILON, 0.0
            f.add_arc(prev, EPSILON, EPSILON, 0.0, ns)
    f.connect()
    info = {
        "pdf_of": pdf_of,
        "phone_of_pdf": phone_of_pdf,
        "num_pdfs": len(phone_of_pdf),
    }
    return f, info


def build_decoding_graph(
    lex: Lexicon,
    g: StdFst,
    topo: Topology = Topology(),
    max_out: int = 16,
):
    """Full pipeline: L ∘ G -> HMM expansion -> epsilon removal -> out-degree
    cap -> flattened DecodingGraph.

    Epsilon removal turns per-frame decoding into a single phase (no closure
    rounds); the out-degree cap enables the decoder's dense padded arc
    layout.  Returns (DecodingGraph, info dict with pdf/phone maps and
    silence pdfs).
    """
    from .optimize import remove_epsilons, split_high_degree

    L = make_lexicon_fst(lex)
    LG = compose(L, g)
    if LG.num_states == 0:
        raise ValueError("empty composition: grammar has no in-vocabulary path")
    H, info = expand_hmm(LG, topo, num_phones=len(lex.phones) - 1)
    H = remove_epsilons(H)
    if H.num_states and max(
        sum(1 for a in arcs if a[0] != EPSILON) for arcs in H.arcs
    ) > max_out:
        H = split_high_degree(H, max_out)
    graph = flatten_fst(H)
    sil_pdfs = [
        pdf for (ph, k), pdf in info["pdf_of"].items() if ph == lex.silence_phone
    ]
    info["silence_pdfs"] = sil_pdfs
    return graph, info
