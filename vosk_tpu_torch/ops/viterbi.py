"""Batched WFST token-passing beam search in PyTorch: the v4, v3 and CSR frame
steps.

Port of `vosk_tpu/ops/viterbi.py` `BatchViterbi`.  The arc tables are
padded (dense [S+1, M] arc rows) or, with `layout="csr"`, the graph's CSR
tables (any out-degree); `frame_step` picks the step as the source does:
"auto" takes v4 when the layout is padded and the graph eps-free, else v3.
On the padded layout the arc rows follow from the step, as the source's
default pack gives them: packed16 for v4, exact3 where pdf ids need more
than 14 bits or for the v3 step (`pack` reads which).  Given the same
log-likelihoods, the frontier and every record plane are bit-equal to the
JAX decoder (tests/test_torch_viterbi.py, tests/test_torch_viterbi_v3.py,
tests/test_torch_viterbi_exact3.py, tests/test_torch_viterbi_csr.py).

v4, the single-phase step over eps-free graphs (those through
`prepare_graph_v4`); per frame, for each channel:
  * expand (kernel `expand_v4`, ops/frame_step.py): every frontier token
    reads its arc row, looks up the acoustic score ll[b, pdf] and scores
    E = K*M candidates with order-preserving int32 cost keys.  packed16
    rows are [S+1, 2M] int32 (f16(w) << 16 | sil << 14 | pdf, then next
    state); exact3 rows [S+1, 3M] (f32 weight bits, next state, meta = sil
    << pdf_bits | pdf).  The v4 step never reads an olabel on the device
    (its records carry (prev, m) and the host reads olabels from
    `dense_olabel`), so its exact3 meta leaves out the olabel bits and the
    source's 4th olabel plane: a layout that differs from the source's, with
    the same results;
  * select (kernel `select_v4`, ops/frame_step.py): from the unsorted
    pool, dedup by next state among the K2 cheapest, the winners ranked by
    cost, the beam prune, the trailing-silence update, the new frontier,
    and the record rows (lattice rows from the R cheapest) written in
    place; the source's three stable sorts, computed without sorting the
    pool.
Its records keep the [T, B, ...] layout of the source's scan.  `step_ops`
holds the two kernels' wrappers (`frame_step.KERNELS`, the pair
(expand, select)); setting it to `frame_step.PLAIN` runs their plain
versions on the same tensors.

v3 (ops/viterbi_v3.py), for graphs that keep epsilon arcs: exact3 arc rows
(f32 weights, the olabel in meta or a 4th plane), three stable torch sorts
a selection, and eps_depth epsilon-closure rounds over padded eps rows;
records per level, [B, T, L, K|R] a chunk.  Its four table lookups go
through `gather_op`, the `gather_rows` kernel (`gather_rows_plain` to
compare on the same tensors).  Where a state has more than 32 eps arcs
its eps rounds are the CSR step's, as in the source.

The sharded search (`decode_chunk_sharded`, the source's sharded mode):
each rank of a mesh's `model` axis (parallel/mesh.py) expands a stripe of
the frontier (`expand_v4` over slots i, i + n, ..., or the v3 expansion),
a MIN all-reduce syncs each channel's beam threshold, and an all_gather
merges every rank's best candidates (`viterbi_v3.shard_candidates`) into
the pool that the step's selection takes; the v4 and padded v3 steps.

CSR (ops/viterbi_csr.py), the source's decoder for graphs above out-degree
16: the tokens' arcs expanded from the CSR tables within a budget E (Ee
for eps rounds), one stable sort for the dedup, the v3 step's records
with CSR arc ids in lat_arc.  Its device code
is torch ops: the source reaches no Pallas kernel on it.

The compiled chunk (the source's `jax.jit(self._decode_entry)`, :283-295,
a `lax.scan` of the frame step and the best reductions, :1388-1419): on a
CUDA device `decode_chunk` replays one captured CUDA graph per chunk shape
(`_ChunkProgram`) where `graph_eligible` holds, the v4 step on the padded
layout with the kernels (`step_ops is frame_step.KERNELS`).  The graph is
the eager body (`_decode_body`: T frame steps, then the reductions) captured
over static inputs; each call copies its frontier, scores and mask in,
replays, and copies the frontier, records and best costs out, so nothing it
returns is a buffer that the next replay overwrites.  Eager by rule,
decided from the decoder and the call before any launch: the CPU, the v3
and CSR steps (a later slice), `step_ops` swapped (`frame_step.PLAIN` holds
the kernels against their plain versions on the card), an empty chunk, and
`decode_chunk_sharded`, whose collectives go through gloo on the host.
`decode_chunk_eager` runs the eager body on any device: the card-side
reference the captured program is held to.

`clone_with_max_active`, `resize_frontier` and `live_tokens` serve the
adaptive max-active ladder (runtime/pipeline.py `run_adaptive`): decoders
at smaller max_active over the same device tables, and the frontier cut or
padded between them (tests/test_torch_adaptive.py).

Bit-parity notes: shifts that the source makes logical are taken after a
mask; the f16 weight is read from the top half-word without a saturating
cast; cost keys rely on int32 wraparound, which torch's int32 arithmetic
keeps; the candidate cost is rounded once after the f32 sum, as XLA's
fused multiply-add rounds it at any acoustic scale (ops/frame_step.py).

The JAX package's ragged bucket ladder (`_frame_step_v4_ragged`) is not
ported: it is bit-equal to the full-K step (tests/test_viterbi_v4.py).
`layout=None` (auto) differs from the source's rule on purpose: the padded
layout serves any out-degree up to 16 and any S < 2^30, as in the source,
and above degree 16 (composed split graphs and word loops, whose degree
capping does not converge, or raw graphs), where the source switches to
its CSR decoder, the port keeps the padded step over wider rows as long as
their table stays within PADDED_MAX_SLOTS: the same search as the source's
padded step with `padded_max_out` raised (tests/test_torch_kaldi_e2e.py
holds the JSON to the source's CSR decode).  Wider tables, and graphs with
no emitting arc, take CSR; `layout="csr"` gives the source's decoder on any
graph.  Lattice records are always written.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import heapq
import threading

import numpy as np
import torch

from ..graph.fst import EPSILON, DecodingGraph
from ..graph.lattice import to_host
from . import viterbi_csr, viterbi_v3
from .frame_step import (
    GRAPH_COUNTS, INF, KERNELS, PM_IDENT_FLAG, PM_MASK, SPEECH_BIT, TSIL_MASK, SelectScratch,
    count_replay,
)
from .gather import gather_rows
# layout=None: the padded layout for any out-degree up to PADDED_MAX_OUT
# (the source's padded limit, above which it takes its CSR decoder), and
# for wider rows while their [S+1, M] table has at most PADDED_MAX_SLOTS
# slots (after prepare_graph_v4 with M=4 the degree is 4 or 8 on most
# graphs); CSR above.  The padded steps dedup among the 2K cheapest
# candidates, the source's default
PADDED_MAX_OUT = 16
PADDED_MAX_SLOTS = 1 << 26
DEDUP_SLACK = 2.0
# v3 eps rounds read padded eps rows up to this out-degree (the source's
# bound; above it they are the CSR step's eps rounds, as in the source),
# and expand the EPS_BUDGET cheapest eps-flagged tokens (the source's
# default)
MAX_PADDED_EPS_OUT = 32
EPS_BUDGET = 1024
# CSR expansion budgets: K * out-degree slots, at most 2^18 (the source's
# defaults)
MAX_EXPAND = 1 << 18
# captured chunk programs a decoder keeps (one per chunk shape), the least
# recently used dropped first
CHUNK_PROGRAMS = 8
# tables on the decoder's device, for `to`
DEVICE_TABLES = ("em_pack", "eps_pack", "_final_cost_t", "em_off", "em_pdf", "em_olabel",
                 "em_w", "em_next", "eps_off", "eps_olabel", "eps_w", "eps_next")


@dataclasses.dataclass
class DecodeParams:
    """Pruning semantics match the reference defaults (src/model.cc:134-147)."""

    beam: float = 13.0
    max_active: int = 7000
    lattice_beam: float = 6.0
    acoustic_scale: float = 1.0


def split_tsil(ts: np.ndarray):
    """Packed tsil values -> (trailing-silence frames, has-speech bool)."""
    ts = np.asarray(ts).astype(np.int64)
    return ts & TSIL_MASK, (ts & SPEECH_BIT) != 0


class BatchViterbi:
    """Channel-batched streaming Viterbi over one decoding graph, with its
    tables on `device`: on the padded layout the v4 step (packed16 or
    exact3 rows) or the v3 step (exact3 rows, eps rounds), chosen by
    `frame_step` ("auto", "v3" or "v4"), with `pack` saying which rows
    ("packed16" or "exact3"); on the CSR layout the CSR step (v3).
    `layout`: None (padded rows where their table fits, else CSR) or
    "csr" (the source's CSR decoder on any graph)."""

    def __init__(
        self,
        graph: DecodingGraph,
        params: DecodeParams,
        silence_pdfs=None,
        optimize_graph: bool = False,
        device="cuda",
        frame_step: str = "auto",
        layout=None,
    ):
        if frame_step not in ("auto", "v3", "v4"):
            raise ValueError(f"frame_step must be 'auto', 'v3' or 'v4'; got {frame_step!r}")
        if layout not in (None, "csr"):
            raise ValueError(f"layout must be None or 'csr'; got {layout!r}")
        if optimize_graph:
            from ..graph.arrayopt import prepare_graph_v4

            graph = prepare_graph_v4(graph, M=4)
        self.graph = graph
        self.params = params
        self.device = torch.device(device)
        self.silence_pdfs = (
            np.asarray(silence_pdfs, np.int64)
            if silence_pdfs is not None and len(np.asarray(silence_pdfs))
            else np.zeros(0, np.int64)
        )
        S = graph.num_states
        self.S = S
        K = min(params.max_active, max(S, 1))
        self.K = K
        self.has_eps = graph.num_eps_arcs > 0
        # no eps arcs -> no closure rounds, regardless of claimed depth
        self.eps_iters = graph.eps_depth if self.has_eps else 0
        if layout is None:
            wide = (graph.max_em_out > PADDED_MAX_OUT
                    and (S + 1) * graph.max_em_out > PADDED_MAX_SLOTS)
            layout = "csr" if graph.max_em_out <= 0 or wide else "padded"
        self.layout = layout
        # the padded layout's em-level lattice records store the in-row arc
        # slot m (hosts rebuild the dense arc id as prev_state * M + m); CSR
        # records store the CSR arc id
        self.lat_arc_is_m = layout == "padded"
        if frame_step == "auto":
            frame_step = "v4" if layout == "padded" and self.eps_iters == 0 else "v3"
        if frame_step == "v4" and (layout != "padded" or self.eps_iters != 0):
            raise ValueError(
                "frame_step='v4' needs the padded layout and an eps-free graph (got "
                f"layout={layout!r}, eps_depth={self.eps_iters}); run with "
                "optimize_graph=True, or take the v3 step"
            )
        self.frame_step = frame_step
        self.M = max(graph.max_em_out, 1)
        # candidates a frame (the padded rows give K * M) and eps-round
        # candidates; lattice rows per frame, dedup prefix and eps sources,
        # sized as the source sizes them (lattice_budget=None, dedup_slack=2.0)
        self.E = K * self.M if layout == "padded" else max(K, 128, min(K * self.M, MAX_EXPAND))
        self.Ee = max(128, min(K * max(graph.max_eps_out, 1), MAX_EXPAND))
        self.R = min(max(self.K, min(2048, self.E)), self.E, self.K + self.Ee)
        self.K2 = max(self.K, int(np.ceil(DEDUP_SLACK * K)))
        self.Eb = max(1, min(K, EPS_BUDGET))
        self.final_cost = np.append(graph.final_cost, np.float32(np.inf)).astype(np.float32)
        self._final_cost_t = torch.as_tensor(self.final_cost, device=self.device)
        self.Me = 0
        if layout == "padded":
            self._build_padded_tables()
        else:
            self.pack = None  # CSR reads no arc rows
        self._build_csr_tables()
        self._init_states, self._init_costs, self._init_prefixes = self._initial_closure()
        # the frame step's kernels; chip_smoke.py and the card tests swap in
        # frame_step.PLAIN (v4) and gather_rows_plain (v3) to compare each
        # kernel with its plain version on the same CUDA tensors
        self.step_ops = KERNELS
        self.gather_op = gather_rows
        self._own_state()

    def _own_state(self) -> None:
        """What the decoder, and each copy of it, keeps to itself: the
        dispatch lock (recognizers of one model share a decoder, one chunk
        at a time, as the source serialises decode_chunk), the select
        kernel's scratch and the captured chunk programs, least recently
        used first.  A copy starts with no program: a graph bakes in the
        tables, K and R of the decoder it was captured on."""
        self._dispatch_lock = threading.RLock()
        self._select_scratch = SelectScratch()
        self._programs = collections.OrderedDict()

    # ------------------------------------------------------------------ init

    def _build_padded_tables(self) -> None:
        """Dense [S+1, M] arc layout packed into one int32 row per state.
        v4, packed16 (2 planes):
          plane1 = f16(w) << 16 | sil << 14 | pdf   (pdf_bits <= 14)
          plane2 = next state | bit 30 if the target has epsilon arcs
        v4, exact3 (3 planes): w (f32 bits), next state | bit 30, meta =
          sil << pdf_bits | pdf (no olabel: the v4 step never reads one)
        v3, exact3 (3 planes, or 4 when the olabel does not fit in meta):
          w (f32 bits), next state | bit 30, meta = olabel << (pdf_bits+1) |
          sil << pdf_bits | pdf, [olabel]
        and, with eps rounds, padded eps rows [S+1, 4Me]: w (f32 bits), next
        state | bit 30, olabel, CSR eps-arc index (lattice records keep CSR
        eps-arc ids).  Pad slots: w=+inf, next=S.  Host-side dense views
        (arc id = state*M + m; f16-rounded weights for packed16) serve
        traceback and lattice finishing."""
        g, S, M = self.graph, self.S, self.M
        if S >= (1 << 30):
            raise ValueError("padded layout supports < 2^30 states")
        A = len(g.em_pdf)
        w = np.full((S + 1, M), np.inf, np.float32)
        nxt = np.full((S + 1, M), S, np.int32)
        pdf = np.zeros((S + 1, M), np.int32)
        ola = np.zeros((S + 1, M), np.int32)
        sil = np.zeros((S + 1, M), np.int32)
        has_eps = np.zeros(S + 1, bool)
        if self.has_eps:
            has_eps[:S] = g.eps_off[1:] > g.eps_off[:-1]
        if A:
            cnt = (g.em_off[1:] - g.em_off[:-1]).astype(np.int64)
            state_of_arc = np.repeat(np.arange(S), cnt)
            pos = np.arange(A) - g.em_off[:-1].astype(np.int64)[state_of_arc]
            w[state_of_arc, pos] = g.em_w
            nxt[state_of_arc, pos] = g.em_next
            pdf[state_of_arc, pos] = g.em_pdf
            sil[state_of_arc, pos] = np.isin(g.em_pdf, self.silence_pdfs)
            ola[state_of_arc, pos] = g.em_olabel
        nsf = np.where(has_eps[nxt], nxt | (1 << 30), nxt).astype(np.int32)

        self.pdf_bits = max(int(pdf.max()).bit_length(), 1)
        # candidate slot e = prev*M + m carries pm = prev << mbits | m
        self.mbits = max((M - 1).bit_length(), 1)
        self.dense_next, self.dense_pdf, self.dense_olabel = nxt, pdf, ola
        # packed16 holds the pdf beside the f16 weight in 14 bits
        self.pack = "packed16" if self.frame_step == "v4" and self.pdf_bits <= 14 else "exact3"
        if self.pack == "exact3":
            self._build_exact3_tables(w, nsf, pdf, sil, ola, has_eps)
            return
        w16 = w.astype(np.float16).view(np.uint16).astype(np.uint32)
        p1 = ((w16 << 16) | (sil.astype(np.uint32) << 14) | pdf.astype(np.uint32))
        self.em_pack = torch.as_tensor(
            np.concatenate([p1.view(np.int32), nsf], axis=1), device=self.device
        )
        self.dense_w = w.astype(np.float16).astype(np.float32)

    def _build_exact3_tables(self, w, nsf, pdf, sil, ola, has_eps) -> None:
        """exact3 rows (source `_build_padded_tables`, exact3 pack and eps
        tables, :356-365 and :380-404); the v4 step's leave the olabel
        out."""
        g, S, pb = self.graph, self.S, self.pdf_bits
        meta = (sil.astype(np.uint32) << pb) | pdf.astype(np.uint32)
        self.dense_w = w
        if self.frame_step == "v4":
            planes = [w.view(np.int32), nsf, meta.view(np.int32)]
            self.em_pack = torch.as_tensor(np.concatenate(planes, axis=1), device=self.device)
            return
        self.ol_in_meta = int(ola.max()) < (1 << (32 - (pb + 1)))
        if self.ol_in_meta:
            meta |= ola.astype(np.uint32) << (pb + 1)
        planes = [w.view(np.int32), nsf, meta.view(np.int32)]
        if not self.ol_in_meta:
            planes.append(ola)
        self.em_pack = torch.as_tensor(np.concatenate(planes, axis=1), device=self.device)
        if not self.eps_iters or g.max_eps_out > MAX_PADDED_EPS_OUT:
            return  # no eps rounds, or the CSR step's (Me = 0)
        Me = max(int(g.max_eps_out), 1)
        An = len(g.eps_next)
        ew = np.full((S + 1, Me), np.inf, np.float32)
        enxt = np.full((S + 1, Me), S, np.int32)
        eola = np.zeros((S + 1, Me), np.int32)
        eidx = np.full((S + 1, Me), -1, np.int32)
        cnt = (g.eps_off[1:] - g.eps_off[:-1]).astype(np.int64)
        st = np.repeat(np.arange(S), cnt)
        pos = np.arange(An) - g.eps_off[:-1].astype(np.int64)[st]
        ew[st, pos] = g.eps_w
        enxt[st, pos] = g.eps_next
        eola[st, pos] = g.eps_olabel
        eidx[st, pos] = np.arange(An, dtype=np.int32)
        ensf = np.where(has_eps[enxt], enxt | (1 << 30), enxt).astype(np.int32)
        self.Me = Me
        self.eps_pack = torch.as_tensor(
            np.concatenate([ew.view(np.int32), ensf, eola, eidx], axis=1), device=self.device)

    def _build_csr_tables(self) -> None:
        """The CSR tables on the device (source :179-197) where a step reads
        them: the em tables for the CSR step, the eps tables for its eps
        rounds and for the v3 step's where Me = 0.  Offsets gain the
        sentinel state S's empty row; the pdf table carries the silence
        flag in bit 30; empty tables hold one zero."""
        g = self.graph
        up = [("eps", g.eps_off, g.eps_olabel, g.eps_w, g.eps_next)] \
            if self.eps_iters and not self.Me else []
        if self.layout == "csr":
            pdf = np.where(np.isin(g.em_pdf, self.silence_pdfs), g.em_pdf | viterbi_csr.SIL_FLAG,
                           g.em_pdf)
            up.append(("em", g.em_off, g.em_olabel, g.em_w, g.em_next))
            self.em_pdf = self._table(pdf, np.int32)
        for name, off, ol, w, nxt in up:
            setattr(self, f"{name}_off", self._table(np.append(off, off[-1]), np.int32))
            setattr(self, f"{name}_olabel", self._table(ol, np.int32))
            setattr(self, f"{name}_w", self._table(w, np.float32))
            setattr(self, f"{name}_next", self._table(nxt, np.int32))

    def _table(self, a, dtype):
        a = np.asarray(a, dtype)
        return torch.as_tensor(a if len(a) else np.zeros(1, dtype), device=self.device)

    def _initial_closure(self):
        g = self.graph
        # transformed graphs (graph/arrayopt.py) carry an explicit initial
        # frontier: the start state's unlabeled-eps closure computed before
        # those eps arcs were removed
        seeds = getattr(g, "init_entries", None) or [(g.start, 0.0)]
        costs = {int(s): float(c) for s, c in seeds}
        prefix: dict[int, tuple] = {int(s): () for s, _ in seeds}
        heap = [(float(c), int(s)) for s, c in seeds]
        heapq.heapify(heap)
        while heap:
            c, s = heapq.heappop(heap)
            if c > costs.get(s, np.inf):
                continue
            for i in range(g.eps_off[s], g.eps_off[s + 1]):
                ns, w, ol = int(g.eps_next[i]), float(g.eps_w[i]), int(g.eps_olabel[i])
                nc = c + w
                if nc < costs.get(ns, np.inf) - 1e-12:
                    costs[ns] = nc
                    prefix[ns] = prefix[s] + ((ol,) if ol != EPSILON else ())
                    heapq.heappush(heap, (nc, ns))
        items = sorted(costs.items(), key=lambda kv: kv[1])[: self.K]
        states = np.full(self.K, self.S, np.int32)
        cost = np.full(self.K, np.inf, np.float32)
        prefixes = []
        for i, (s, c) in enumerate(items):
            states[i] = s
            cost[i] = c
            prefixes.append(list(prefix[s]))
        while len(prefixes) < self.K:
            prefixes.append([])
        return states, cost, prefixes

    def clone_with_max_active(self, k: int) -> "BatchViterbi":
        """A decoder over the same graph tables with max_active k (source
        :230-257): every device table and host view is shared by reference,
        and only the K-derived sizes, the initial closure and `_own_state`
        (lock, kernel scratch, chunk programs) are the clone's own.  R
        follows the source's clone, not `__init__` (no cap at K + Ee).  The step's kernels
        (`step_ops`, `gather_op`) are copied when the clone is made: a later
        swap on this decoder does not reach it.  max_active is an upper bound
        on live tokens, so wherever fewer stay live than the clone's K, it
        decodes exactly as this decoder.  The padded layout only."""
        if self.layout != "padded":
            raise ValueError("clone_with_max_active requires the padded layout")
        c = copy.copy(self)
        c.params = dataclasses.replace(self.params, max_active=k)
        K = min(k, max(self.S, 1))
        c.K = K
        c.E = K * self.M
        c.K2 = max(K, int(np.ceil(DEDUP_SLACK * K)))
        c.Eb = max(1, min(K, self.Eb))
        c.R = min(max(K, min(2048, c.E)), c.E)
        c._init_states, c._init_costs, c._init_prefixes = c._initial_closure()
        c._own_state()
        return c

    def resize_frontier(self, frontier, k_new: int) -> dict:
        """A frontier moved to k_new slots, between max_active variants
        (source :259-275): truncation keeps slots [:k_new] (select leaves
        the slots sorted by cost, so these are the best tokens), growth pads
        dead slots (state S, cost +inf, tsil 0)."""
        B, K = frontier["state"].shape
        if k_new == K:
            return frontier
        if k_new < K:
            return {k: v[:, :k_new].contiguous() for k, v in frontier.items()}
        fill = {"state": self.S, "cost": float("inf"), "tsil": 0}
        return {k: torch.cat([v, v.new_full((B, k_new - K), fill[k])], dim=1)
                for k, v in frontier.items()}

    def live_tokens(self, frontier) -> np.ndarray:
        """Per-channel count of live (finite-cost) tokens, on the host (one
        pull): the adaptive max-active signal (source :277-281)."""
        return np.isfinite(to_host(frontier["cost"])).sum(axis=1)

    def to(self, device) -> "BatchViterbi":
        """The same decoder with its device tables on `device` (host views
        and the prepared graph are shared, not rebuilt; `_own_state` is the
        copy's own)."""
        c = copy.copy(self)
        c.device = torch.device(device)
        for k in DEVICE_TABLES:
            if hasattr(self, k):
                setattr(c, k, getattr(self, k).to(c.device))
        c._own_state()
        return c

    def __getstate__(self):
        """Pickled (torch.save) without its lock, kernel scratch and chunk
        programs, so that the ranks of a mesh can load one prepared
        decoder."""
        st = dict(self.__dict__)
        del st["_dispatch_lock"], st["_select_scratch"], st["_programs"]
        return st

    def __setstate__(self, st):
        self.__dict__.update(st)
        self._own_state()

    def init_frontier(self, batch: int) -> dict:
        dev = self.device
        return {
            "state": torch.as_tensor(self._init_states, device=dev).repeat(batch, 1),
            "cost": torch.as_tensor(self._init_costs, device=dev).repeat(batch, 1),
            # packed trailing-silence count + has-speech bit per token
            "tsil": torch.zeros((batch, self.K), dtype=torch.int32, device=dev),
        }

    # ------------------------------------------------------------- v4 step

    def _frame_step_v4(self, frontier, ll, valid, out, mesh=None, scratch=None):
        """One whole-batch frame step: expand, then select.  ll: [B, P]
        (rows may be strided); valid: [B] bool.  Returns (frontier, records
        {pm, state, f_cost} [B, K] and {lat_pm, lat_cost} [B, R]), the
        records written into `out` ({name: [B, K|R]}).

        mesh: None, or the mesh of the sharded search (source
        `_frame_step_v4_sharded`, :1494-1532): this rank expands its stripe
        of the frontier (global slots i, i + n, ... for coordinate i of n on
        `viterbi_v3.SHARD_AXIS`), and `viterbi_v3.shard_candidates` merges the
        ranks' best candidates within the synced beam into the pool that
        select_v4 takes.  select_v4 breaks ties by pool position, as a
        stable sort does, and the merged pool's segments are each cost
        sorted in rank order, so the source's sort of the merged pool
        (:1531) is left out: it would not move a tie.

        scratch: select_v4's (`SelectScratch`), the decoder's by default."""
        i, n = (0, 1) if mesh is None else viterbi_v3.shard_coordinate(mesh)
        cands = self.step_ops.expand(
            self.em_pack, frontier["state"], frontier["cost"], ll,
            self.params.acoustic_scale, self.S, self.M, self.mbits, self.pdf_bits
            if self.pack == "exact3" else None, slot_base=i, slot_stride=n)
        if mesh is not None:
            cands = viterbi_v3.shard_candidates(self, mesh, cands[0], cands[1:], self.K // n)
        return self.step_ops.select(
            *cands, frontier, valid, self.params.beam, self.params.lattice_beam,
            self.S, self.mbits, self.K2, self.R, out,
            scratch=self._select_scratch if scratch is None else scratch)

    # ------------------------------------------------------------- chunk API

    def record_lead(self, T: int, B: int) -> tuple:
        """The leading dims of one chunk's records: (T, B) for v4, the
        source's (B, T) for v3 and CSR."""
        return (T, B) if self.frame_step == "v4" else (B, T)

    def record_buffers(self, lead: tuple, device=None) -> dict:
        """Uninitialised record planes on `device` (the decoder's by
        default): v4 {name: [*lead, K or R]}, v3 and CSR {name: [*lead, L, K or R]}
        with L = 1 + eps_iters levels a frame; `lead` is `record_lead(T, B)`
        for one chunk."""
        dev = self.device if device is None else device
        K, R = self.K, self.R
        if self.frame_step == "v4":
            shapes = {"pm": (torch.int32, (K,)), "state": (torch.int32, (K,)),
                      "f_cost": (torch.float32, (K,)), "lat_pm": (torch.int32, (R,)),
                      "lat_cost": (torch.float32, (R,))}
        else:
            L = 1 + self.eps_iters
            shapes = {**{k: (dt, (L, K)) for k, dt in viterbi_v3.K_PLANES.items()},
                      **{k: (dt, (L, R)) for k, dt in viterbi_v3.R_PLANES.items()}}
        return {k: torch.empty((*lead, *n), dtype=dt, device=dev)
                for k, (dt, n) in shapes.items()}

    @property
    def graph_eligible(self) -> bool:
        """Whether `decode_chunk` on CUDA tensors replays a captured chunk
        program: the v4 step on the padded layout with the kernels
        (`step_ops is frame_step.KERNELS`)."""
        return self.frame_step == "v4" and self.layout == "padded" and self.step_ops is KERNELS

    def decode_chunk(self, frontier, loglikes, valid=None, out=None):
        """loglikes: [B, T, P] float32; valid: [B, T] bool.  Returns
        (frontier, records, best cost [B], best final cost [B]), all on the
        decoder's device; records are {name: [T, B, K or R]} (v4) or {name:
        [B, T, L, K or R]} (v3 and CSR).  out: optional preallocated records
        (`record_buffers(record_lead(T, B))` or views of a larger buffer) to
        write into instead of allocating.

        On CUDA tensors, where `graph_eligible`, the chunk replays the
        captured program of its shape (the first call of a shape captures
        it); what it returns is fresh, or `out`.  Elsewhere, and for an
        empty chunk, the eager body (`decode_chunk_eager`)."""
        B, T, _ = loglikes.shape
        if loglikes.is_cuda and self.graph_eligible and B * T:
            return self._replay(frontier, loglikes, valid, out)
        return self._decode(frontier, loglikes, valid, out)

    def decode_chunk_eager(self, frontier, loglikes, valid=None, out=None):
        """`decode_chunk` launched op by op on any device: the body that the
        captured chunk program holds, and its reference on the card."""
        return self._decode(frontier, loglikes, valid, out)

    def decode_chunk_sharded(self, mesh, frontier, loglikes, valid=None, out=None):
        """`decode_chunk` with each frame's expansion sharded over the
        `model` axis of `mesh` (parallel/mesh.py; source
        `decode_chunk_sharded` :1534, at its defaults axis="model" and
        shard_slack=2, `viterbi_v3.SHARD_AXIS` and `SHARD_SLACK`): run
        by every rank of the mesh, each on the channels of its data
        coordinate (frontier [B / n_data, K], loglikes [B / n_data, T, P]).
        A rank expands its stripe of K / n frontier slots, the ranks of the
        model axis agree on each channel's best candidate (a MIN all-reduce)
        and so on the beam threshold, and each contributes its
        min(K / n * M, 2 * K / n) best candidates within it to an
        all_gather; every rank then selects from the merged pool, so the
        ranks of the model axis return the same frontier.  Identical to
        decode_chunk up to the order of equal-cost ties whenever no rank has
        more than its contribution inside the beam.  Returns what
        decode_chunk returns, records in the same layouts (v4 [T, B, K|R],
        where the source swaps them to [B, T, K|R] and its v4 traceback then
        reads the wrong rows; ROADMAP C).  The padded layout only: the
        source's sharded step reads the padded arc rows, which the CSR
        layout has not."""
        _, n = viterbi_v3.shard_coordinate(mesh)
        if self.K % n:
            raise ValueError(f"sharded mode needs max_active % n_shards == 0; got K = "
                             f"{self.K} over {n} shards")
        if self.layout != "padded":
            raise NotImplementedError(
                "the sharded search runs the padded layout's steps (v4 and v3); the "
                "source's sharded step reads padded arc rows, which layout='csr' has not")
        return self._decode(frontier, loglikes, valid, out, mesh)

    def _decode(self, frontier, loglikes, valid, out, mesh=None):
        B, T, _ = loglikes.shape
        dev = loglikes.device
        if valid is None:
            valid = torch.ones((B, T), dtype=torch.bool, device=dev)
        with self._dispatch_lock:
            recs = out if out is not None else self.record_buffers(self.record_lead(T, B), dev)
            return self._decode_body(frontier, loglikes.to(torch.float32), valid, recs, mesh)

    def _decode_body(self, frontier, ll32, valid, recs, mesh=None, scratch=None):
        """The chunk (source `_decode_chunk_impl`, :1388-1419): every frame
        step, records written into `recs`, then the best and best-final
        reductions.  Run eagerly, or captured by a chunk program over its
        static tensors and its own select scratch."""
        T = ll32.shape[1]
        if self.frame_step == "v4":
            for t in range(T):
                # frame t of the chunk read in place; records written at t
                frontier, _ = self._frame_step_v4(
                    frontier, ll32[:, t], valid[:, t], {k: v[t] for k, v in recs.items()},
                    mesh, scratch)
        else:
            # the v3 and CSR lookups read contiguous ll rows: one copy a
            # chunk
            ll_t = ll32.transpose(0, 1).contiguous()
            step = viterbi_csr.frame_step if self.layout == "csr" else (
                lambda *a: viterbi_v3.frame_step_v3(*a, mesh=mesh))
            for t in range(T):
                frontier = step(self, frontier, ll_t[t], valid[:, t],
                                {k: v[:, t] for k, v in recs.items()})
        best_cost = frontier["cost"].amin(dim=1)
        final_tot = frontier["cost"] + self._final_cost_t[frontier["state"].long()]
        return frontier, recs, best_cost, final_tot.amin(dim=1)

    def _program_key(self, ll32) -> tuple:
        """A chunk program's key: (device, B, T, K, R, P, the f32 scores'
        strides), the shapes a captured graph is fixed to."""
        B, T, P = ll32.shape
        return (ll32.device, B, T, self.K, self.R, P, ll32.stride())

    def _replay(self, frontier, loglikes, valid, out):
        """decode_chunk through the captured program of the chunk's shape,
        captured on the first call of that shape.  Under the dispatch lock,
        on the caller's current stream: copy-in, replay, copy-out, so one
        call's work is enqueued whole before another's copy-in.  A failed
        capture or replay raises."""
        ll32 = loglikes.to(torch.float32)
        key = self._program_key(ll32)
        stream = torch.cuda.current_stream(ll32.device)
        with self._dispatch_lock:
            prog = self._programs.get(key)
            if prog is None:
                prog = _ChunkProgram(self, ll32)
                prog.load(frontier, ll32, valid, stream)
                prog.capture(self, stream)
                self._programs[key] = prog
                if len(self._programs) > CHUNK_PROGRAMS:
                    _, old = self._programs.popitem(last=False)
                    old.done.synchronize()  # its last call's work is done before it is freed
            else:
                self._programs.move_to_end(key)
                prog.load(frontier, ll32, valid, stream)
            prog.replay()
            return prog.unload(out, stream)

    def best_tsil(self, frontier) -> torch.Tensor:
        """[B] int32 on the frontier's device: the best (non-final) token's
        packed trailing-silence count and has-speech bit (split it with
        `split_tsil`)."""
        cost = frontier["cost"]
        slot = torch.where(torch.isfinite(cost), cost, INF).argmin(dim=1)
        return frontier["tsil"].gather(1, slot[:, None])[:, 0]

    def endpoint_info(self, frontier):
        """O(1) endpoint inputs from the device-tracked token state: per
        channel, the best (non-final) token's trailing-silence frame count
        and whether its path contains speech, pulled to the host as numpy
        (trailing [B], has_speech [B])."""
        return split_tsil(to_host(self.best_tsil(frontier)))

    # ------------------------------------------------------------ host side

    def host_em_arc(self, ai: int) -> tuple[float, int, int]:
        """(graph_weight, olabel, pdf) of an emitting-arc record id: dense
        ids for the padded layout, CSR indices otherwise."""
        if self.layout == "padded":
            s, m = divmod(int(ai), self.M)
            return (
                float(self.dense_w[s, m]),
                int(self.dense_olabel[s, m]),
                int(self.dense_pdf[s, m]),
            )
        g = self.graph
        return float(g.em_w[ai]), int(g.em_olabel[ai]), int(g.em_pdf[ai])

    def best_slot(self, frontier, channel, use_final):
        """(slot, cost) where a traceback starts: the best token with its
        final cost added when use_final and any token is final, else the
        best token; (None, inf) when the channel has no live token."""
        state = to_host(frontier["state"][channel])
        cost = to_host(frontier["cost"][channel])
        tot = cost + self.final_cost[state]
        if use_final and np.isfinite(tot).any():
            slot = int(np.argmin(tot))
            best_cost = float(tot[slot])
        else:
            slot = int(np.argmin(cost))
            best_cost = float(cost[slot])
        if not np.isfinite(cost[slot]):
            return None, np.inf
        return slot, best_cost

    def traceback(self, records, frontier, channel):
        """Best-path traceback on the host (source :1617-1633): (cost,
        olabels, per-frame pdf alignment).  records may be segments of
        different K widths (`FusedPipeline.run_adaptive`'s, each flattened
        to [T, B, K]): a frame's row is read at the slot the next frame
        names, whatever its width.  The source's use_final / at_start /
        init_states are not taken (no caller sets them); traceback_with_frames
        keeps them."""
        cost, ols_frames, pdfs = self.traceback_with_frames(records, frontier, channel)
        return cost, [o for o, _ in ols_frames], pdfs

    def traceback_with_frames(
        self, records, frontier, channel, use_final=True, at_start=True,
        init_states=None,
    ):
        """Best-path traceback: (cost, [(olabel, frame_idx)], pdf
        alignment), frame_idx counting valid decoded frames; reads one
        channel's rows to the host.  v3 records (no "pm" plane, as the
        source dispatches) go to `viterbi_v3.traceback_v3`.  For v4 records
        ({pm, state} each [T, B, K]) this is a copy of the source's
        `_traceback_v4`: olabel/pdf/weight come from the host dense views
        keyed by (source state, arc slot m); the device never writes them.
        init_states anchors frame 0's arc sources at a fold boundary
        (at_start=False); v3 records carry olabel and pdf inline and ignore
        it."""
        if not (records and "pm" in records[0]):
            return viterbi_v3.traceback_v3(self, records, frontier, channel, use_final, at_start)
        if init_states is None:
            if not at_start:
                raise ValueError(
                    "v4 traceback with at_start=False needs init_states "
                    "(the fold-boundary frontier's state row)"
                )
            init_states = self._init_states
        slot, best_cost = self.best_slot(frontier, channel, use_final)
        if slot is None:
            return np.inf, [], []

        pm_fr, st_fr = [], []
        for rec in records:
            pm = to_host(rec["pm"][:, channel])  # [T, K]
            st = to_host(rec["state"][:, channel])
            for t in range(pm.shape[0]):
                pm_fr.append(pm[t])
                st_fr.append(st[t])

        mmask = (1 << self.mbits) - 1
        steps: list[tuple[int, int, int]] = []  # (t, prev, m), backwards
        for t in range(len(pm_fr) - 1, -1, -1):
            pmv = int(pm_fr[t][slot])
            if pmv < 0:
                return best_cost, [], []
            if pmv & PM_IDENT_FLAG:
                slot = (pmv & PM_MASK) >> self.mbits
                continue
            prev = pmv >> self.mbits
            steps.append((t, prev, pmv & mmask))
            slot = prev
        steps.reverse()

        ols_frames: list[tuple[int, int]] = []
        pdfs: list[int] = []
        for fidx, (t, prev, m) in enumerate(steps):
            # source state of the arc: the prev slot's state one frame back
            if t > 0:
                src_state = int(st_fr[t - 1][prev])
            else:
                src_state = int(init_states[prev])
            pdfs.append(int(self.dense_pdf[src_state, m]))
            ol = int(self.dense_olabel[src_state, m])
            if ol:
                ols_frames.append((ol, fidx))
        if at_start and 0 <= slot < len(self._init_prefixes):
            prefix = [(ol, 0) for ol in self._init_prefixes[slot]]
            ols_frames = prefix + ols_frames
        return best_cost, ols_frames, pdfs


def _check_like(name, x, like) -> None:
    if not isinstance(x, torch.Tensor) or (x.shape, x.dtype, x.device) != (
            like.shape, like.dtype, like.device):
        raise ValueError(f"{name}: got {getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))} on {getattr(x, 'device', None)}; "
                         f"the chunk needs {like.dtype} {tuple(like.shape)} on {like.device}")


class _ChunkProgram:
    """The captured v4 chunk of one shape: the counterpart of the source's
    `jax.jit(self._decode_entry)`, whose cache is also keyed by shape.

    Static inputs: the frontier {state, cost, tsil} [B, K], the f32 scores
    [B, T, P] at the caller's strides and valid [B, T]; the records
    [T, B, K|R]; the graph of `_decode_body` over them (T expand_v4 +
    select_v4 steps, the best and best-final reductions), whose static
    outputs are the new frontier and both best costs; and select_v4's
    scratch, which the graph's pointers name and so lives with it.  Before
    the capture the body runs once, eagerly, on the capturing stream: that
    sizes the scratch and makes the kernel library's one-time per-device
    queries (shared-memory attributes, cluster occupancy) outside the
    capture.  `done` is recorded after each call's copy-out; the next
    call's stream waits on it, so a caller on another stream cannot race
    the static buffers."""

    def __init__(self, dec, ll32):
        B, T, _ = ll32.shape
        dev = ll32.device
        self.T = T
        self.frontier = {k: torch.empty((B, dec.K), dtype=dt, device=dev)
                         for k, dt in (("state", torch.int32), ("cost", torch.float32),
                                       ("tsil", torch.int32))}
        self.ll = torch.empty_strided(ll32.shape, ll32.stride(), dtype=torch.float32,
                                      device=dev)
        self.valid = torch.empty((B, T), dtype=torch.bool, device=dev)
        self.recs = dec.record_buffers(dec.record_lead(T, B), dev)
        self.scratch = SelectScratch()
        self.graph = self.outs = None
        self.done = torch.cuda.Event()

    def _run(self, dec):
        return dec._decode_body(self.frontier, self.ll, self.valid, self.recs,
                                scratch=self.scratch)

    def load(self, frontier, ll32, valid, stream) -> None:
        """Copy a call's inputs into the static ones, on `stream`, after the
        last call's copy-out."""
        for k, v in self.frontier.items():
            _check_like(f"frontier[{k}]", frontier[k], v)
        if valid is not None:
            _check_like("valid", valid, self.valid)
        stream.wait_event(self.done)
        for k, v in self.frontier.items():
            v.copy_(frontier[k])
        self.ll.copy_(ll32)
        if valid is None:
            self.valid.fill_(True)
        else:
            self.valid.copy_(valid)

    def capture(self, dec, stream) -> None:
        """The warm-up, then the capture, on a side stream that waits for
        the copy-in; `stream` then waits for the side stream."""
        side = torch.cuda.Stream(stream.device)
        side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self._run(dec)
            # other threads' CUDA calls stay legal while this one captures
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                frontier, _, best, best_final = self._run(dec)
            finally:
                graph.capture_end()
        stream.wait_stream(side)
        self.graph, self.outs = graph, (frontier, best, best_final)
        GRAPH_COUNTS["captures"] += 1

    def replay(self) -> None:
        self.graph.replay()
        count_replay(self.T)

    def unload(self, out, stream):
        """decode_chunk's result, copied out of the static outputs: records
        into `out` when given, else fresh tensors, and a fresh frontier and
        best costs."""
        if out is None:
            recs = {k: v.clone() for k, v in self.recs.items()}
        else:
            for k, v in self.recs.items():
                _check_like(f"out[{k}]", out[k], v)
                out[k].copy_(v)
            recs = out
        frontier, best, best_final = self.outs
        res = ({k: v.clone() for k, v in frontier.items()}, recs, best.clone(),
               best_final.clone())
        self.done.record(stream)
        return res
