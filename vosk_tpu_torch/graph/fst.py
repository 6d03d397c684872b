"""Weighted FSTs, the flattened decoding-graph tables and symbol tables.

Copy of `vosk_tpu/graph/fst.py` (numpy only: `StdFst`, `DecodingGraph`,
`flatten_fst`, `SymbolTable`), kept in the port because nothing under
`vosk_tpu` imports without jax.  tests/test_torch_copies.py holds it to its
source.

Semiring: tropical (costs = -log prob, min-plus), matching OpenFST StdArc.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

INF = np.float32(np.inf)
NO_STATE = -1
EPSILON = 0


class StdFst:
    """Mutable vector FST over the tropical semiring (host-side).

    Arc fields mirror OpenFST StdArc: ilabel, olabel, weight (cost), nextstate.
    """

    def __init__(self):
        self.arcs: list[list[tuple[int, int, float, int]]] = []
        self.final: list[float] = []
        self.start: int = NO_STATE

    def add_state(self) -> int:
        self.arcs.append([])
        self.final.append(float("inf"))
        return len(self.arcs) - 1

    def add_states(self, n: int) -> None:
        for _ in range(n):
            self.add_state()

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, cost: float = 0.0) -> None:
        self.final[s] = cost

    def add_arc(self, s: int, ilabel: int, olabel: int, weight: float, nextstate: int) -> None:
        self.arcs[s].append((ilabel, olabel, float(weight), nextstate))

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def arcsort(self) -> None:
        for a in self.arcs:
            a.sort(key=lambda arc: (arc[0], arc[1], arc[3]))

    def connect(self) -> None:
        """Remove states not on a successful path (OpenFST Connect)."""
        n = self.num_states
        if self.start == NO_STATE or n == 0:
            return
        # forward reachability
        fwd = np.zeros(n, bool)
        stack = [self.start]
        fwd[self.start] = True
        while stack:
            s = stack.pop()
            for _, _, _, ns in self.arcs[s]:
                if not fwd[ns]:
                    fwd[ns] = True
                    stack.append(ns)
        # backward reachability from finals
        radj: list[list[int]] = [[] for _ in range(n)]
        for s in range(n):
            for _, _, _, ns in self.arcs[s]:
                radj[ns].append(s)
        bwd = np.zeros(n, bool)
        stack = [s for s in range(n) if self.final[s] != float("inf")]
        for s in stack:
            bwd[s] = True
        while stack:
            s = stack.pop()
            for p in radj[s]:
                if not bwd[p]:
                    bwd[p] = True
                    stack.append(p)
        keep = fwd & bwd
        remap = -np.ones(n, np.int64)
        remap[keep] = np.arange(keep.sum())
        new_arcs = []
        new_final = []
        for s in range(n):
            if not keep[s]:
                continue
            new_arcs.append(
                [(il, ol, w, int(remap[ns])) for il, ol, w, ns in self.arcs[s] if keep[ns]]
            )
            new_final.append(self.final[s])
        self.arcs = new_arcs
        self.final = new_final
        self.start = int(remap[self.start]) if keep[self.start] else NO_STATE


@dataclasses.dataclass
class DecodingGraph:
    """Flattened CSR arc tables for the token-passing decoder.

    Emitting arcs consume one acoustic frame; their ilabel is pre-mapped to a
    pdf index via `ilabel_to_pdf` at build time (the reference maps
    transition-id -> pdf-id through the TransitionModel).  Epsilon arcs
    (ilabel==0) form the closure tables.
    """

    num_states: int
    start: int
    # emitting arcs (CSR by source state)
    em_off: np.ndarray      # int32 [S+1]
    em_pdf: np.ndarray      # int32 [Ae]   acoustic row index
    em_olabel: np.ndarray   # int32 [Ae]
    em_w: np.ndarray        # float32 [Ae]
    em_next: np.ndarray     # int32 [Ae]
    # epsilon arcs (CSR by source state)
    eps_off: np.ndarray     # int32 [S+1]
    eps_olabel: np.ndarray  # int32 [An]
    eps_w: np.ndarray       # float32 [An]
    eps_next: np.ndarray    # int32 [An]
    final_cost: np.ndarray  # float32 [S] (inf = non-final)
    eps_depth: int          # bound on epsilon-closure iterations needed
    max_em_out: int         # max emitting out-degree of any state
    max_eps_out: int        # max epsilon out-degree

    @property
    def num_emitting_arcs(self) -> int:
        return len(self.em_pdf)

    @property
    def num_eps_arcs(self) -> int:
        return len(self.eps_next)


def _eps_closure_depth(fst: StdFst, cap: int = 64) -> int:
    """Longest acyclic epsilon out-chain (capped).  With weighted epsilon
    cycles the closure converges anyway; the decoder also re-checks
    convergence, this is just the static iteration bound.

    Hitting the cap is LOUD: a capped depth means the decoder's per-frame
    closure rounds cannot reach the deepest eps chains and paths would be
    silently lost (r5 finding: a 119-deep chain from the old linear
    split_high_degree broke 600-word decodes)."""
    n = fst.num_states
    eps_adj: list[list[int]] = [[] for _ in range(n)]
    for s in range(n):
        for il, _, _, ns in fst.arcs[s]:
            if il == EPSILON:
                eps_adj[s].append(ns)
    depth = np.zeros(n, np.int32)
    # iterate to fixpoint, capped
    for _ in range(cap):
        changed = False
        for s in range(n):
            for ns in eps_adj[s]:
                if depth[s] + 1 > depth[ns] and depth[s] + 1 <= cap:
                    depth[ns] = depth[s] + 1
                    changed = True
        if not changed:
            break
    else:
        import warnings

        warnings.warn(
            f"epsilon-closure depth exceeds the cap ({cap}); the decoder "
            "runs only that many closure rounds per frame and may lose "
            "paths — restructure the graph (split_high_degree now builds "
            "log-depth trees) or raise eps_depth_cap",
            stacklevel=2,
        )
    return int(depth.max()) if n else 0


def flatten_fst(
    fst: StdFst,
    ilabel_to_pdf: Optional[np.ndarray] = None,
    eps_depth_cap: int = 64,
) -> DecodingGraph:
    """Flatten a host FST into the decoder's CSR tables.

    ilabel_to_pdf: int32 map from arc ilabel to acoustic-output row (pdf).
    Default: pdf = ilabel - 1 (native graphs label arcs 1..num_pdfs).
    """
    n = fst.num_states
    em_off = np.zeros(n + 1, np.int32)
    eps_off = np.zeros(n + 1, np.int32)
    em_rows, eps_rows = [], []
    max_em, max_eps = 0, 0
    for s in range(n):
        ne, nn = 0, 0
        for il, ol, w, ns in fst.arcs[s]:
            if il == EPSILON:
                eps_rows.append((ol, w, ns))
                nn += 1
            else:
                pdf = int(ilabel_to_pdf[il]) if ilabel_to_pdf is not None else il - 1
                em_rows.append((pdf, ol, w, ns))
                ne += 1
        em_off[s + 1] = em_off[s] + ne
        eps_off[s + 1] = eps_off[s] + nn
        max_em, max_eps = max(max_em, ne), max(max_eps, nn)

    em = np.array(em_rows, dtype=np.float64).reshape(-1, 4)
    ep = np.array(eps_rows, dtype=np.float64).reshape(-1, 3)
    return DecodingGraph(
        num_states=n,
        start=fst.start,
        em_off=em_off,
        em_pdf=em[:, 0].astype(np.int32),
        em_olabel=em[:, 1].astype(np.int32),
        em_w=em[:, 2].astype(np.float32),
        em_next=em[:, 3].astype(np.int32),
        eps_off=eps_off,
        eps_olabel=ep[:, 0].astype(np.int32),
        eps_w=ep[:, 1].astype(np.float32),
        eps_next=ep[:, 2].astype(np.int32),
        final_cost=np.array(fst.final, np.float32),
        eps_depth=_eps_closure_depth(fst, eps_depth_cap),
        max_em_out=max_em,
        max_eps_out=max_eps,
    )


class SymbolTable:
    """Word/phone symbol table (OpenFST SymbolTable semantics; id 0 is
    <epsilon>, cf. vosk_api.h:69-74)."""

    def __init__(self, symbols: Optional[Iterable[str]] = None):
        self._sym_to_id: dict[str, int] = {}
        self._id_to_sym: list[str] = []
        if symbols is not None:
            for s in symbols:
                self.add(s)

    def add(self, sym: str) -> int:
        if sym in self._sym_to_id:
            return self._sym_to_id[sym]
        i = len(self._id_to_sym)
        self._sym_to_id[sym] = i
        self._id_to_sym.append(sym)
        return i

    def find(self, sym: str) -> int:
        return self._sym_to_id.get(sym, -1)

    def name(self, i: int) -> str:
        if 0 <= i < len(self._id_to_sym):
            return self._id_to_sym[i]
        return ""

    def __len__(self) -> int:
        return len(self._id_to_sym)

    def __contains__(self, sym: str) -> bool:
        return sym in self._sym_to_id

    @classmethod
    def read_text(cls, path) -> "SymbolTable":
        """Read OpenFST text symbol table ('sym id' per line)."""
        t = cls()
        pairs = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    pairs.append((parts[0], int(parts[1])))
        size = max(i for _, i in pairs) + 1 if pairs else 0
        t._id_to_sym = [""] * size
        for sym, i in pairs:
            t._id_to_sym[i] = sym
            t._sym_to_id[sym] = i
        return t

    def write_text(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for i, s in enumerate(self._id_to_sym):
                f.write(f"{s} {i}\n")
