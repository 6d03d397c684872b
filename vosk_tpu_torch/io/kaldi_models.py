"""Kaldi model-object readers built on io/kaldiio: TransitionModel,
HmmTopology, nnet3 networks (supported component subset), and OpenFST
binary graphs — the objects the reference loads at src/model.cc:233-306.

These parse the on-disk formats directly (no Kaldi linkage).  The nnet3
reader targets the xconfig families the reference serves (TDNN-F chain
models per training/local/chain/run_tdnn.sh, x-vector extractors) and
reports unsupported components explicitly.

Copy of `vosk_tpu/io/kaldi_models.py` (numpy only), kept in the port
because nothing under `vosk_tpu` imports without jax;
tests/test_torch_copies.py holds it to its source.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .kaldiio import BinaryReader, BinaryWriter, KaldiReadError, open_kaldi


# ------------------------------------------------------------- HmmTopology


@dataclasses.dataclass
class HmmState:
    forward_pdf_class: int
    self_loop_pdf_class: int
    transitions: List[Tuple[int, float]]


@dataclasses.dataclass
class TopologyEntry:
    phones: List[int]
    states: List[HmmState]


class HmmTopology:
    def __init__(self):
        self.phones: List[int] = []
        self.phone2idx: List[int] = []
        self.entries: List[List[HmmState]] = []

    @classmethod
    def read(cls, r: BinaryReader) -> "HmmTopology":
        t = cls()
        r.expect_token("<Topology>")
        t.phones = r.read_int_vector()
        t.phone2idx = r.read_int_vector()
        n = r.read_basic_int()
        for _ in range(n):
            ns = r.read_basic_int()
            states = []
            for _ in range(ns):
                fwd = r.read_basic_int()
                # newer format writes two pdf classes when they differ; the
                # stream encodes this via pair flag in the int itself — Kaldi
                # writes forward_pdf_class then (if kTwo...) ... the binary
                # format always writes both since 2017 chain models:
                self_loop = r.read_basic_int()
                ntrans = r.read_basic_int()
                trans = []
                for _ in range(ntrans):
                    idx = r.read_basic_int()
                    p = r.read_basic_float()
                    trans.append((idx, p))
                states.append(HmmState(fwd, self_loop, trans))
            t.entries.append(states)
        r.expect_token("</Topology>")
        return t

    def write(self, w: BinaryWriter) -> None:
        w.write_token("<Topology>")
        w.write_int_vector(self.phones)
        w.write_int_vector(self.phone2idx)
        w.write_basic_int(len(self.entries))
        for states in self.entries:
            w.write_basic_int(len(states))
            for st in states:
                w.write_basic_int(st.forward_pdf_class)
                w.write_basic_int(st.self_loop_pdf_class)
                w.write_basic_int(len(st.transitions))
                for idx, p in st.transitions:
                    w.write_basic_int(idx)
                    w.write_basic_float(p)
        w.write_token("</Topology>")

    def entry_for_phone(self, phone: int) -> List[HmmState]:
        return self.entries[self.phone2idx[self.phones.index(phone)]]


# --------------------------------------------------------- TransitionModel


class TransitionModel:
    """tid <-> (phone, hmm-state, pdf) mapping (kaldi hmm/transition-model).

    What the decoder needs: id2pdf (transition-id -> pdf-id) and id2phone
    (for silence detection / word boundaries).
    """

    def __init__(self):
        self.topo = HmmTopology()
        # tuples: (phone, hmm_state, forward_pdf, self_loop_pdf)
        self.tuples: List[Tuple[int, int, int, int]] = []
        self.log_probs = np.zeros(0, np.float32)
        self._build_derived()

    @classmethod
    def read(cls, r: BinaryReader) -> "TransitionModel":
        tm = cls()
        r.expect_token("<TransitionModel>")
        tm.topo = HmmTopology.read(r)
        tok = r.read_token()
        if tok not in ("<Tuples>", "<Triples>"):
            raise KaldiReadError(f"expected tuples, got {tok}")
        is_tuples = tok == "<Tuples>"
        n = r.read_basic_int()
        tuples = []
        for _ in range(n):
            phone = r.read_basic_int()
            hmm_state = r.read_basic_int()
            fwd = r.read_basic_int()
            self_loop = r.read_basic_int() if is_tuples else fwd
            tuples.append((phone, hmm_state, fwd, self_loop))
        tm.tuples = tuples
        r.expect_token("</Tuples>" if is_tuples else "</Triples>")
        r.expect_token("<LogProbs>")
        tm.log_probs = r.read_vector()
        r.expect_token("</LogProbs>")
        r.expect_token("</TransitionModel>")
        tm._build_derived()
        return tm

    def write(self, w: BinaryWriter) -> None:
        w.write_token("<TransitionModel>")
        self.topo.write(w)
        w.write_token("<Tuples>")
        w.write_basic_int(len(self.tuples))
        for phone, hmm_state, fwd, self_loop in self.tuples:
            w.write_basic_int(phone)
            w.write_basic_int(hmm_state)
            w.write_basic_int(fwd)
            w.write_basic_int(self_loop)
        w.write_token("</Tuples>")
        w.write_token("<LogProbs>")
        w.write_vector(self.log_probs)
        w.write_token("</LogProbs>")
        w.write_token("</TransitionModel>")

    def _build_derived(self) -> None:
        """state2id: transition-state -> first transition-id; per-state
        transition counts come from the topology entry's state."""
        self.state2id = [1]
        self.id2state = [0]  # 1-based
        self.id2pdf_list = [-1]
        self.id2phone_list = [-1]
        for ts, (phone, hmm_state, fwd, self_loop) in enumerate(self.tuples, 1):
            entry = self.topo.entry_for_phone(phone)
            ntrans = len(entry[hmm_state].transitions)
            self.state2id.append(self.state2id[-1] + ntrans)
            for i, (dest_idx, _p) in enumerate(entry[hmm_state].transitions):
                self.id2state.append(ts)
                # self-loop transition -> self_loop_pdf; else forward pdf
                is_self_loop = dest_idx == hmm_state
                self.id2pdf_list.append(self_loop if is_self_loop else fwd)
                self.id2phone_list.append(phone)

    @property
    def num_transition_ids(self) -> int:
        return len(self.id2state) - 1

    @property
    def num_pdfs(self) -> int:
        return int(max(max(t[2], t[3]) for t in self.tuples)) + 1 if self.tuples else 0

    def id2pdf(self) -> np.ndarray:
        """int32 [num_tids + 1]; index 0 unused (epsilon)."""
        return np.asarray(self.id2pdf_list, np.int32)

    def id2phone(self) -> np.ndarray:
        return np.asarray(self.id2phone_list, np.int32)


# ----------------------------------------------------------- OpenFST read


@dataclasses.dataclass
class RawFst:
    start: int
    # per state: final weight and arc array rows (ilabel, olabel, weight, next)
    finals: np.ndarray
    arcs_per_state: List[np.ndarray]


def read_fst(path) -> RawFst:
    """Read an OpenFST binary file: VectorFst or ConstFst over StdArc
    (the formats the reference loads at model.cc:280-284)."""
    with open(path, "rb") as f:
        magic = struct.unpack("<i", f.read(4))[0]
        if magic != 2125659606:
            raise KaldiReadError(f"not an OpenFST binary file (magic {magic})")
        def read_string():
            n = struct.unpack("<i", f.read(4))[0]
            return f.read(n).decode("utf-8")

        fst_type = read_string()
        arc_type = read_string()
        version = struct.unpack("<i", f.read(4))[0]
        flags = struct.unpack("<i", f.read(4))[0]
        properties = struct.unpack("<Q", f.read(8))[0]
        start = struct.unpack("<q", f.read(8))[0]
        num_states = struct.unpack("<q", f.read(8))[0]
        num_arcs = struct.unpack("<q", f.read(8))[0]
        if arc_type != "standard":
            raise KaldiReadError(f"unsupported arc type {arc_type}")
        # optional symbol tables
        if flags & 0x1:  # HAS_ISYMBOLS
            _skip_symbol_table(f)
        if flags & 0x2:  # HAS_OSYMBOLS
            _skip_symbol_table(f)

        if fst_type == "vector":
            finals = np.zeros(num_states, np.float32)
            arcs_per_state: List[np.ndarray] = []
            for s in range(num_states):
                fw = struct.unpack("<f", f.read(4))[0]
                n = struct.unpack("<q", f.read(8))[0]
                data = np.frombuffer(f.read(16 * n), dtype="<i4").reshape(n, 4)
                finals[s] = fw
                arcs_per_state.append(data)
            return RawFst(start, finals, arcs_per_state)
        if fst_type == "ngram":
            from .ngram_fst import read_ngram_data

            start2, finals, arcs_per_state = read_ngram_data(f, start)
            return RawFst(start2, finals, arcs_per_state)
        if fst_type == "const":
            # ConstFst: states array then arcs array
            # const fst data is 16-byte aligned with a marker in newer versions
            _align(f, 16)
            states = np.frombuffer(f.read(16 * num_states), dtype="<u1").reshape(
                num_states, 16
            )
            finals = states[:, 0:4].copy().view("<f4").reshape(-1)
            pos = states[:, 4:8].copy().view("<i4").reshape(-1)
            narcs = states[:, 8:12].copy().view("<i4").reshape(-1)
            _align(f, 16)
            arcs = np.frombuffer(f.read(16 * num_arcs), dtype="<i4").reshape(num_arcs, 4)
            arcs_per_state = [
                arcs[pos[s] : pos[s] + narcs[s]] for s in range(num_states)
            ]
            return RawFst(start, finals, arcs_per_state)
        raise KaldiReadError(f"unsupported fst type {fst_type}")


def _align(f, n: int) -> None:
    pos = f.tell()
    if pos % n:
        f.read(n - pos % n)


def _skip_symbol_table(f) -> None:
    magic = struct.unpack("<i", f.read(4))[0]
    if magic != 2125658996:
        raise KaldiReadError("bad symbol table magic")
    n = struct.unpack("<i", f.read(4))[0]
    f.read(n)  # name
    struct.unpack("<q", f.read(8))  # available key
    count = struct.unpack("<q", f.read(8))[0]
    for _ in range(count):
        n = struct.unpack("<i", f.read(4))[0]
        f.read(n)
        struct.unpack("<q", f.read(8))


def raw_fst_to_std(raw: RawFst):
    """RawFst -> graph.fst.StdFst (weights bit-cast from the i4 view)."""
    from ..graph.fst import StdFst

    f = StdFst()
    f.add_states(len(raw.finals))
    f.set_start(int(raw.start))
    for s, fw in enumerate(raw.finals):
        if np.isfinite(fw) and fw != np.float32(np.inf):
            f.set_final(s, float(fw))
    for s, arcs in enumerate(raw.arcs_per_state):
        if len(arcs) == 0:
            continue
        w = arcs[:, 2].copy().view("<f4")
        for i in range(len(arcs)):
            f.add_arc(s, int(arcs[i, 0]), int(arcs[i, 1]), float(w[i]), int(arcs[i, 3]))
    return f
