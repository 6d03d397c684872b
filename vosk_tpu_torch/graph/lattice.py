"""Host-side lattice finishing: build a word lattice from the decoder's
records, prune, compute arc posteriors (forward-backward), extract n-best.

Copy of `vosk_tpu/graph/lattice.py`: `LatArc`, `Lattice`,
`rescore_lattice` (LM rescoring by on-demand composition),
`convert_v4_records`, `build_lattice` and `splice_lattices`.  Records and
frontiers may be torch tensors on any device; `to_host` pulls what the host
reads.  Of v4 records, `_v4_entries` finds on their device the entries the
host reads (slots and lattice rows with an arc, live slots), and only those
come to the host: `convert_v4_records` scatters them into the source's
dense planes, and `build_lattice` reads them as they are (the source
converts every [T, K] plane on the host); both give the source's results,
bit for bit.  The native
library in `core/` builds and finishes the same lattices faster
(runtime/native_lattice.py); this Python lattice serves the streaming
recognizer's windowed (folded) lattices and the fallbacks of
runtime/finishing.py, as in the source.  tests/test_torch_copies.py holds
it to its source.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

NEG_INF = float("-inf")


def to_host(x) -> np.ndarray:
    """numpy view of a host array or a torch tensor on any device (an
    explicit device-to-host copy for CUDA tensors)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class LatArc:
    src: int
    dst: int
    olabel: int
    graph_cost: float
    acoustic_cost: float
    is_frame: bool  # consumed an acoustic frame (em level arc)
    pdf: int = -1

    @property
    def cost(self) -> float:
        return self.graph_cost + self.acoustic_cost


class Lattice:
    """DAG over nodes 0..N-1 (0-cost source node 0; virtual super-final is
    implicit via node final costs)."""

    def __init__(self):
        self.arcs: List[LatArc] = []
        self.out: List[List[int]] = [[]]
        self.in_: List[List[int]] = [[]]
        self.final: List[float] = [math.inf]
        self.node_frame: List[int] = [0]  # decoded-frame index of node

    def add_node(self, frame: int) -> int:
        self.out.append([])
        self.in_.append([])
        self.final.append(math.inf)
        self.node_frame.append(frame)
        return len(self.out) - 1

    def add_arc(self, arc: LatArc) -> None:
        i = len(self.arcs)
        self.arcs.append(arc)
        self.out[arc.src].append(i)
        self.in_[arc.dst].append(i)

    @property
    def num_nodes(self) -> int:
        return len(self.out)

    # ---------------------------------------------------------- traversal

    def topo_order(self) -> List[int]:
        """Nodes are created in topological order by construction."""
        return list(range(self.num_nodes))

    def shortest(self) -> Tuple[float, List[int]]:
        """(best total cost incl. final, best arc path)."""
        n = self.num_nodes
        d = np.full(n, np.inf)
        back = np.full(n, -1, np.int64)
        d[0] = 0.0
        for u in range(n):
            if not np.isfinite(d[u]):
                continue
            for ai in self.out[u]:
                a = self.arcs[ai]
                nd = d[u] + a.cost
                if nd < d[a.dst]:
                    d[a.dst] = nd
                    back[a.dst] = ai
        tot = d + np.asarray(self.final)
        if not np.isfinite(tot).any():
            return math.inf, []
        v = int(np.argmin(tot))
        best = float(tot[v])
        path = []
        while back[v] >= 0:
            path.append(int(back[v]))
            v = self.arcs[int(back[v])].src
        path.reverse()
        return best, path

    # ------------------------------------------------------------ pruning

    def copy(self) -> "Lattice":
        out = Lattice()
        out.arcs = [
            LatArc(a.src, a.dst, a.olabel, a.graph_cost, a.acoustic_cost,
                   a.is_frame, a.pdf)
            for a in self.arcs
        ]
        out.out = [list(x) for x in self.out]
        out.in_ = [list(x) for x in self.in_]
        out.final = list(self.final)
        out.node_frame = list(self.node_frame)
        return out

    def prune(self, beam: float, node_map_out=None) -> "Lattice":
        """Keep arcs on paths within `beam` of the best path (Kaldi
        lattice-beam semantics).  node_map_out (optional list) receives the
        old->new node id mapping (-1 = dropped)."""
        n = self.num_nodes
        fwd = np.full(n, np.inf)
        fwd[0] = 0.0
        for u in range(n):
            if not np.isfinite(fwd[u]):
                continue
            for ai in self.out[u]:
                a = self.arcs[ai]
                fwd[a.dst] = min(fwd[a.dst], fwd[u] + a.cost)
        bwd = np.asarray(self.final, float).copy()
        for u in range(n - 1, -1, -1):
            for ai in self.out[u]:
                a = self.arcs[ai]
                bwd[u] = min(bwd[u], a.cost + bwd[a.dst])
        best = float(np.min(fwd + bwd))
        if not np.isfinite(best):
            if node_map_out is not None:
                node_map_out[:] = list(range(n))
            return self
        keep_arc = [
            np.isfinite(fwd[a.src])
            and np.isfinite(bwd[a.dst])
            and fwd[a.src] + a.cost + bwd[a.dst] <= best + beam
            for a in self.arcs
        ]
        # rebuild with remapped nodes
        keep_node = np.zeros(n, bool)
        keep_node[0] = True
        for a, k in zip(self.arcs, keep_arc):
            if k:
                keep_node[a.src] = keep_node[a.dst] = True
        for u in range(n):
            if np.isfinite(self.final[u]) and np.isfinite(fwd[u]) and fwd[u] + self.final[u] <= best + beam:
                keep_node[u] = True
        remap = -np.ones(n, np.int64)
        out = Lattice()
        out.final[0] = self.final[0]
        out.node_frame[0] = self.node_frame[0]
        remap[0] = 0
        for u in range(1, n):
            if keep_node[u]:
                remap[u] = out.add_node(self.node_frame[u])
                out.final[int(remap[u])] = self.final[u]
        for a, k in zip(self.arcs, keep_arc):
            if k and remap[a.src] >= 0 and remap[a.dst] >= 0:
                out.add_arc(
                    LatArc(
                        int(remap[a.src]),
                        int(remap[a.dst]),
                        a.olabel,
                        a.graph_cost,
                        a.acoustic_cost,
                        a.is_frame,
                        a.pdf,
                    )
                )
        if node_map_out is not None:
            node_map_out[:] = [int(x) for x in remap]
        return out

    def scale_graph(self, scale: float) -> "Lattice":
        """Scale graph costs in place (reference applies
        GraphLatticeScale(0.9) before result extraction,
        recognizer.cc:719)."""
        for a in self.arcs:
            a.graph_cost *= scale
        return self

    # --------------------------------------------------------- posteriors

    def arc_posteriors(self, scale: float = 1.0) -> np.ndarray:
        """Log-domain forward-backward; returns per-arc posterior
        probability."""

        def logsumexp2(a, b):
            if a == NEG_INF:
                return b
            if b == NEG_INF:
                return a
            m = max(a, b)
            return m + math.log(math.exp(a - m) + math.exp(b - m))

        n = self.num_nodes
        alpha = [NEG_INF] * n
        alpha[0] = 0.0
        for u in range(n):
            if alpha[u] == NEG_INF:
                continue
            for ai in self.out[u]:
                a = self.arcs[ai]
                alpha[a.dst] = logsumexp2(alpha[a.dst], alpha[u] - scale * a.cost)
        beta = [NEG_INF] * n
        for u in range(n):
            if np.isfinite(self.final[u]):
                beta[u] = -scale * self.final[u]
        for u in range(n - 1, -1, -1):
            for ai in self.out[u]:
                a = self.arcs[ai]
                beta[u] = logsumexp2(beta[u], -scale * a.cost + beta[a.dst])
        total = NEG_INF
        for u in range(n):
            if np.isfinite(self.final[u]):
                total = logsumexp2(total, alpha[u] - scale * self.final[u])
        post = np.zeros(len(self.arcs))
        for i, a in enumerate(self.arcs):
            lp = alpha[a.src] - scale * a.cost + beta[a.dst] - total
            post[i] = math.exp(min(lp, 0.0))
        return post

    # -------------------------------------------------------------- nbest

    def nbest(self, n: int) -> List[Tuple[float, List[int]]]:
        """Exact n shortest paths (A* with exact backward heuristic).
        Returns [(total_cost, arc path)]."""
        import heapq

        N = self.num_nodes
        bwd = np.asarray(self.final, float).copy()
        for u in range(N - 1, -1, -1):
            for ai in self.out[u]:
                a = self.arcs[ai]
                bwd[u] = min(bwd[u], a.cost + bwd[a.dst])
        if not np.isfinite(bwd[0]):
            return []
        results = []
        # heap entries: (priority, seq, node, cost_so_far, path)
        cnt = 0
        heap = [(float(bwd[0]), cnt, 0, 0.0, [])]
        while heap and len(results) < n:
            _, _, u, cost, path = heapq.heappop(heap)
            if np.isfinite(self.final[u]) and (
                not self.out[u]
                or True  # final nodes can also continue; emit this completion
            ):
                results.append((cost + float(self.final[u]), path))
                # continue expanding for longer paths through u as well
            for ai in self.out[u]:
                a = self.arcs[ai]
                if not np.isfinite(bwd[a.dst]):
                    continue
                cnt += 1
                heapq.heappush(
                    heap,
                    (cost + a.cost + float(bwd[a.dst]), cnt, a.dst, cost + a.cost, path + [ai]),
                )
        results.sort(key=lambda x: x[0])
        return results[:n]

    # ------------------------------------------------------------- words

    def path_words(self, path: List[int]) -> List[Tuple[int, int, int]]:
        """(word, start_frame, end_frame) per word on an arc path; a word's
        span runs from its arc's frame to the next word's frame (or path
        end), with trailing non-frame arcs excluded."""
        out = []
        for i, ai in enumerate(path):
            a = self.arcs[ai]
            if a.olabel != 0:
                out.append((a.olabel, self.node_frame[a.src], ai))
        words = []
        T_end = self.node_frame[self.arcs[path[-1]].dst] if path else 0
        for j, (w, f0, ai) in enumerate(out):
            f1 = out[j + 1][1] if j + 1 < len(out) else T_end
            words.append((w, f0, max(f1, f0 + 1)))
        return words


def rescore_lattice(
    lat: Lattice,
    subtract_lm=None,
    add_lm=None,
    add_scale: float = 1.0,
) -> Lattice:
    """LM rescoring by on-demand composition: expand nodes to
    (node, sub_state, add_state); each word arc's graph cost gets
    -sub_lm.score + add_scale*add_lm.score; finals adjusted with </s> costs.

    This is the reference's rescoring chain (recognizer.cc:680-693): compose
    with the negated graph LM, then with the const-ARPA (and optionally an
    RNNLM mixture via `add_lm` being a mixture object).
    """
    if subtract_lm is None and add_lm is None:
        return lat

    init = (
        lat,
        subtract_lm.initial_state() if subtract_lm else None,
        add_lm.initial_state() if add_lm else None,
    )
    out = Lattice()
    out.final[0] = math.inf
    # map (node, sub_state, add_state) -> new node; process in topo order of
    # the source lattice (nodes are topo-ordered by construction)
    states_of: dict = defaultdict(dict)  # node -> {(ss, as): new_node}
    states_of[0][(init[1], init[2])] = 0
    out.node_frame[0] = lat.node_frame[0]

    for u in lat.topo_order():
        for key, nu in list(states_of[u].items()):
            ss, as_ = key
            if np.isfinite(lat.final[u]):
                fc = lat.final[u]
                if subtract_lm is not None:
                    fc -= subtract_lm.final_cost(ss)
                if add_lm is not None:
                    fc += add_scale * add_lm.final_cost(as_)
                out.final[nu] = min(out.final[nu], fc)
            for ai in lat.out[u]:
                a = lat.arcs[ai]
                gc = a.graph_cost
                ss2, as2 = ss, as_
                if a.olabel != 0:
                    if subtract_lm is not None:
                        c, ss2 = subtract_lm.score(ss, a.olabel)
                        gc -= c
                    if add_lm is not None:
                        c, as2 = add_lm.score(as_, a.olabel)
                        gc += add_scale * c
                key2 = (ss2, as2)
                tgt = states_of[a.dst].get(key2)
                if tgt is None:
                    tgt = out.add_node(lat.node_frame[a.dst])
                    states_of[a.dst][key2] = tgt
                out.add_arc(
                    LatArc(nu, tgt, a.olabel, gc, a.acoustic_cost, a.is_frame, a.pdf)
                )
    return out


def convert_v4_records(
    dec, records: List[dict], channel: int, init_states=None
) -> List[dict]:
    """Expand v4 decoder records into the v3 schema the native lattice
    library consumes.

    v4 records ({pm, state, f_cost, lat_pm, lat_cost}, [T, B, ...],
    ops/viterbi.py:_frame_step_v4) carry no olabel/pdf/next-state planes;
    this host-side adapter reconstructs them from the decoder's dense arc
    views, producing one v3-style dict per chunk with [1, T, 1, K/R] arrays
    (single channel, single level) so existing consumers index [0].

    init_states: state row [K] just before the records' first frame, when
    the records do not start at utterance start (fold boundary); defaults
    to the decoder's initial closure.
    """
    e = _v4_entries(dec, records, channel, init_states)
    out = []
    for c, rec in enumerate(records):
        state = to_host(rec["state"][:, channel])  # [T, K]
        f_cost = to_host(rec["f_cost"][:, channel])
        lat_cost = to_host(rec["lat_cost"][:, channel])  # [T, R]
        lo, hi = e["first"][c], e["first"][c + 1]
        a = slice(*np.searchsorted(e["a_t"], [lo, hi]))
        ti, ki, real, m, src = (e["a_t"][a] - lo, e["a_k"][a], e["a_real"][a], e["a_m"][a],
                                e["a_src"][a])
        prev = np.full(state.shape, -1, np.int32)
        prev[ti, ki] = e["a_p"][a]
        pdf = np.full(state.shape, -1, np.int32)
        olabel = np.zeros(state.shape, np.int32)
        pdf[ti[real], ki[real]] = dec.dense_pdf[src[real], m[real]]
        olabel[ti[real], ki[real]] = dec.dense_olabel[src[real], m[real]]

        r = slice(*np.searchsorted(e["r_t"], [lo, hi]))
        ti, ri, real = e["r_t"][r] - lo, e["r_r"][r], e["r_real"][r]
        lat_prev = np.full(lat_cost.shape, -1, np.int32)
        lat_prev[ti, ri] = e["r_p"][r]
        lat_arc = np.full(lat_cost.shape, -1, np.int32)
        lat_arc[ti[real], ri[real]] = e["r_m"][r][real]
        lat_ns = np.full(lat_cost.shape, dec.S, np.int32)
        lat_ns[ti, ri] = e["r_ns"][r]
        out.append(
            {
                "f_state": state[None, :, None, :],
                "f_cost": f_cost[None, :, None, :],
                "prev": prev[None, :, None, :],
                "olabel": olabel[None, :, None, :],
                "pdf": pdf[None, :, None, :],
                "lat_ns": lat_ns[None, :, None, :],
                "lat_prev": lat_prev[None, :, None, :],
                "lat_arc": lat_arc[None, :, None, :],
                "lat_cost": lat_cost[None, :, None, :],
            }
        )
    return out


def _v4_entries(dec, records: List[dict], channel: int, init_states=None) -> dict:
    """What the host reads of v4 records ({name: [T, B, K|R]}) of `channel`,
    found on the records' device so that only these entries come to the
    host (a frame of K slots usually holds a few hundred live ones), frames
    counted over the chunks in order (`first`: each chunk's first frame,
    then the total); each list sorted by frame:

    - a_*: each slot with an arc (pm >= 0): frame t, slot k, previous slot
      p, arc slot m, whether the arc is real (not the identity of a masked
      frame) and the state it leaves, src (the frontier row of the frame
      before: `init_states` before the first, by default the decoder's
      initial closure);
    - r_*: each lattice row with an arc (lat_pm >= 0): t, row r, p, m, real,
      the next state ns (the real arc's, an identity row's mirror of the
      frontier) and its cost;
    - n_*: each live slot (finite cost, state below S): t, k, state, cost.

    `convert_v4_records` scatters them into dense planes, `build_lattice`
    reads them as they are."""
    import torch

    from ..ops.viterbi import PM_IDENT_FLAG, PM_MASK

    S, mbits = dec.S, dec.mbits
    mmask = (1 << mbits) - 1
    ident, pm_mask = int(PM_IDENT_FLAG), int(PM_MASK)
    pm, state, f_cost, lat_pm, lat_cost = (
        torch.cat([torch.as_tensor(r[k])[:, channel] for r in records])
        for k in ("pm", "state", "f_cost", "lat_pm", "lat_cost"))
    init = to_host(init_states if init_states is not None else dec._init_states)
    init = torch.as_tensor(np.asarray(init), dtype=state.dtype, device=state.device)
    prev_rows = torch.cat([init[None], state[:-1]])  # the frontier each frame leaves

    at, ak = (pm >= 0).nonzero(as_tuple=True)
    av = pm[at, ak]
    ap = ((av & pm_mask) >> mbits).long()
    a_real = (av & ident) == 0
    rt, rr = (lat_pm >= 0).nonzero(as_tuple=True)
    rv = lat_pm[rt, rr]
    rp = ((rv & pm_mask) >> mbits).long()
    r_real = (rv & ident) == 0
    nt, nk = (torch.isfinite(f_cost) & (state != S)).nonzero(as_tuple=True)
    names = ["a_t", "a_k", "a_p", "a_m", "a_real", "a_src",
             "r_t", "r_r", "r_p", "r_m", "r_real", "r_src", "n_t", "n_k", "n_state"]
    ints = [at, ak, ap, av & mmask, a_real, prev_rows[at, ap],
            rt, rr, rp, rv & mmask, r_real, torch.where(r_real, prev_rows[rt, rp], state[rt, rp]),
            nt, nk, state[nt, nk]]
    e = dict(zip(names, np.split(to_host(torch.cat([x.long() for x in ints])),
                                 np.cumsum([len(x) for x in ints])[:-1])))
    e["r_cost"], e["n_cost"] = np.split(
        to_host(torch.cat([lat_cost[rt, rr], f_cost[nt, nk]])), [len(rt)])
    for k in ("a_real", "r_real"):
        e[k] = e[k].astype(bool)
    # an identity row (masked frame) mirrors the frontier: its src is its ns
    e["r_ns"] = e["r_src"].copy()
    real = e["r_real"]
    e["r_ns"][real] = dec.dense_next[e["r_src"][real], e["r_m"][real]]
    e["first"] = np.cumsum([0] + [r["pm"].shape[0] for r in records])
    return e


def _frames_dense(records: List[dict], channel: int, S: int):
    """The frames of v3-layout records ({name: [B, T, L, K|R]}) for
    `build_lattice`: (frame in its chunk, whether it emits, per level (live
    slots, their states, their costs, and of the live lattice rows: next
    state, previous slot, arc, cost)).  A slot lives with a finite cost and
    a state below S, a lattice row with a finite cost and a next state
    below S."""
    for rec in records:
        f_state = to_host(rec["f_state"][channel])  # [T, L, K]
        f_cost = to_host(rec["f_cost"][channel])
        lat_ns = to_host(rec["lat_ns"][channel])  # [T, L, R]
        lat_prev = to_host(rec["lat_prev"][channel])
        lat_arc = to_host(rec["lat_arc"][channel])
        lat_cost = to_host(rec["lat_cost"][channel])
        pdf_rec = to_host(rec["pdf"][channel])
        live_k = np.isfinite(f_cost) & (f_state != S)
        live_r = np.isfinite(lat_cost) & (lat_ns != S)
        emits = (pdf_rec[:, 0] >= 0).any(axis=1)
        for t in range(f_state.shape[0]):
            levels = []
            for lvl in range(f_state.shape[1]):
                ks = np.flatnonzero(live_k[t, lvl])
                rs = np.flatnonzero(live_r[t, lvl])
                levels.append((ks, f_state[t, lvl, ks], f_cost[t, lvl, ks], lat_ns[t, lvl, rs],
                               lat_prev[t, lvl, rs], lat_arc[t, lvl, rs], lat_cost[t, lvl, rs]))
            yield t, bool(emits[t]), levels


def _frames_v4(dec, records: List[dict], channel: int, init_states=None):
    """`_frames_dense` of `convert_v4_records(dec, records, channel,
    init_states)`, read from `_v4_entries`: a frame emits where one of its
    real arcs has a pdf; its lattice rows are those with a finite cost and a
    next state below S (an identity row has no arc, -1)."""
    e = _v4_entries(dec, records, channel, init_states)
    N = e["first"][-1]
    real = e["a_real"]
    emits = np.zeros(N, bool)
    emits[e["a_t"][real][dec.dense_pdf[e["a_src"][real], e["a_m"][real]] >= 0]] = True
    keep = np.isfinite(e["r_cost"]) & (e["r_ns"] != dec.S)
    rt, r_ns, r_prev, r_cost = (e[k][keep] for k in ("r_t", "r_ns", "r_p", "r_cost"))
    r_arc = np.where(e["r_real"], e["r_m"], -1)[keep]
    nt = e["n_t"]
    nb = np.searchsorted(nt, np.arange(N + 1))
    rb = np.searchsorted(rt, np.arange(N + 1))
    for g in range(N):
        a, b, c, d = nb[g], nb[g + 1], rb[g], rb[g + 1]
        t = g - e["first"][np.searchsorted(e["first"], g, side="right") - 1]
        yield t, bool(emits[g]), [(e["n_k"][a:b], e["n_state"][a:b], e["n_cost"][a:b],
                                   r_ns[c:d], r_prev[c:d], r_arc[c:d], r_cost[c:d])]


def build_lattice(
    records: List[dict],
    frontier,
    channel: int,
    dec,
    use_final: bool = True,
    node_map_out: Optional[dict] = None,
    init_override=None,
    init_map_out: Optional[dict] = None,
) -> Tuple[Lattice, Dict[int, int]]:
    """Assemble the lattice for one channel from decoder records.

    dec: the BatchViterbi (for arc tables + initial frontier).
    init_override: optional (states [K], costs [K]) anchoring level 0 at a
    mid-stream fold boundary instead of the utterance start (bounded-memory
    streaming: older records were folded into a frozen best-path prefix).
    Returns (lattice, final_slot->node map is internal; lattice final costs
    already set).
    """
    # the frontier stays batched [B, K] even when v4 records are converted
    # to a single-channel view below — final costs must keep reading the
    # ORIGINAL channel (a ch>0 stream would otherwise get stream 0's finals)
    fr_channel = channel
    if records and "pm" in records[0]:
        frames = _frames_v4(dec, records, channel,
                            None if init_override is None else init_override[0])
    else:
        frames = _frames_dense(records, channel, dec.S)
    graph = dec.graph
    em_olabel, em_w = graph.em_olabel, graph.em_w
    em_pdf = graph.em_pdf
    eps_olabel, eps_w = graph.eps_olabel, graph.eps_w
    K = dec.K

    lat = Lattice()
    # level 0: initial frontier; node per slot
    if init_override is not None:
        init_states, init_costs = init_override
        init_prefixes = [[] for _ in range(len(init_states))]
    else:
        init_states = dec._init_states
        init_costs = dec._init_costs
        init_prefixes = dec._init_prefixes
    # padded-layout (v3) em-level lat_arc stores the in-row arc slot m;
    # the dense arc id is reconstructed as prev_state * M + m
    lat_arc_is_m = getattr(dec, "lat_arc_is_m", False)
    prev_nodes: Dict[int, int] = {}  # slot -> node id
    prev_costs: Dict[int, float] = {}
    prev_states: Dict[int, int] = {}  # slot -> graph state (for lat_arc_is_m)
    for k in np.where(np.isfinite(init_costs))[0]:
        k = int(k)
        # connect source to initial slots with their closure cost; if the
        # closure emitted words (rare), chain one arc per prefix word.
        # Nodes MUST be created in topological order (chain before slot node).
        prefix = init_prefixes[k]
        src = 0
        for w in prefix[:-1]:
            mid = lat.add_node(0)
            lat.add_arc(LatArc(src, mid, w, 0.0, 0.0, False))
            src = mid
        node = lat.add_node(0)
        prev_nodes[k] = node
        prev_costs[k] = float(init_costs[k])
        prev_states[k] = int(init_states[k])
        if init_map_out is not None:
            init_map_out[k] = node
        lat.add_arc(
            LatArc(
                src,
                node,
                prefix[-1] if prefix else 0,
                float(init_costs[k]),
                0.0,
                False,
            )
        )

    frame_idx = 0
    for t, is_real, levels in frames:
        for lvl, (slots, states, costs, r_ns, r_prev, r_arc, r_cost) in enumerate(levels):
            # build nodes of this level
            state_slot: Dict[int, int] = {}
            nodes: Dict[int, int] = {}
            ncosts: Dict[int, float] = {}
            nstates: Dict[int, int] = {}
            cur_frame = frame_idx + (1 if (is_real and lvl >= 0) else 0)
            for k, st, c in zip(slots.tolist(), states.tolist(), costs.tolist()):
                nodes[k] = lat.add_node(cur_frame)
                ncosts[k] = float(c)
                nstates[k] = int(st)
                state_slot.setdefault(int(st), k)
                if node_map_out is not None:
                    node_map_out[(len(node_map_out) // 10**9, t, lvl, k)] = nodes[k]
            # arcs
            for ns, pslot, ai, total in zip(r_ns.tolist(), r_prev.tolist(), r_arc.tolist(),
                                            r_cost.tolist()):
                slot = state_slot.get(ns)
                if slot is None:
                    continue
                if pslot < 0 or pslot not in prev_nodes:
                    continue
                total = float(total)
                delta = total - prev_costs[pslot]
                if lvl == 0 and is_real:
                    if lat_arc_is_m and ai >= 0:
                        ai = prev_states[pslot] * dec.M + ai
                    gw, ol, pdf = dec.host_em_arc(ai) if ai >= 0 else (0.0, 0, -1)
                    lat.add_arc(
                        LatArc(
                            prev_nodes[pslot],
                            nodes[slot],
                            ol,
                            gw,
                            delta - gw,
                            True,
                            pdf,
                        )
                    )
                else:
                    if ai >= 0:
                        lat.add_arc(
                            LatArc(
                                prev_nodes[pslot],
                                nodes[slot],
                                int(eps_olabel[ai]),
                                float(eps_w[ai]),
                                delta - float(eps_w[ai]),
                                False,
                            )
                        )
                    else:  # carry
                        lat.add_arc(
                            LatArc(prev_nodes[pslot], nodes[slot], 0, delta, 0.0, False)
                        )
            prev_nodes, prev_costs, prev_states = nodes, ncosts, nstates
        if is_real:
            frame_idx += 1

    # final costs on last-level nodes
    final_cost = np.asarray(dec.final_cost)
    f_state_last = to_host(frontier["state"][fr_channel])
    any_final = False
    for k, node in prev_nodes.items():
        st = int(f_state_last[k])
        fc = float(final_cost[st]) if st <= dec.S else math.inf
        if use_final and np.isfinite(fc):
            lat.final[node] = fc
            any_final = True
    if not (use_final and any_final):
        for k, node in prev_nodes.items():
            lat.final[node] = 0.0
    return lat, prev_nodes


def splice_lattices(
    pre: Lattice,
    pre_slot_nodes: Dict[int, int],
    post: Lattice,
    post_init_nodes: Dict[int, int],
    frame_offset: int,
) -> Tuple[Lattice, Dict[int, int]]:
    """Concatenate `post` (a window lattice built with init_override at a
    fold boundary) onto `pre` IN PLACE.

    The windowed-lattice alternative to freezing the folded prefix to one
    best path (the reference keeps alternatives for the whole utterance via
    incremental determinization, model.h:24): post's level-0 anchor nodes
    (post_init_nodes: slot -> post node) attach to pre's boundary nodes
    (pre_slot_nodes: slot -> pre node) with zero-cost arcs — pre's path
    cost to a boundary node already equals the absolute cost init_override
    carried, so post's absolute-cost source arcs are dropped, not added.

    pre's pseudo-finals (0.0 markers from use_final=False builds) are
    cleared; post's finals and node frames (shifted by frame_offset) carry
    over.  Returns (pre, node_map) with node_map[post_id] -> new id.
    """
    for i in range(len(pre.final)):
        pre.final[i] = math.inf
    nmap = {0: 0}
    slot_of_node = {n: k for k, n in post_init_nodes.items()}
    for u in range(1, post.num_nodes):
        nmap[u] = pre.add_node(post.node_frame[u] + frame_offset)
        if math.isfinite(post.final[u]):
            pre.final[nmap[u]] = post.final[u]
    for a in post.arcs:
        if a.src == 0 and a.dst in slot_of_node:
            k = slot_of_node[a.dst]
            pn = pre_slot_nodes.get(k)
            if pn is None:
                continue  # boundary slot pruned out of pre: unreachable
            pre.add_arc(
                LatArc(pn, nmap[a.dst], a.olabel, 0.0, 0.0, False)
            )
        else:
            pre.add_arc(
                LatArc(
                    nmap[a.src], nmap[a.dst], a.olabel,
                    a.graph_cost, a.acoustic_cost, a.is_frame, a.pdf,
                )
            )
    return pre, nmap
