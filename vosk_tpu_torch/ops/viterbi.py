"""Batched WFST token-passing beam search in PyTorch: the v4 and v3 frame steps.

Port of `vosk_tpu/ops/viterbi.py` `BatchViterbi` over the padded layout.
`frame_step` picks the step as the source does: "auto" takes v4 when the
graph is eps-free, else v3.  Given the same log-likelihoods, the frontier
and every record plane are bit-equal to the JAX decoder
(tests/test_torch_viterbi.py, tests/test_torch_viterbi_v3.py).

v4, the single-phase step over eps-free graphs (those through
`prepare_graph_v4`) with packed16 arc rows; per frame, for each channel:
  * expand (kernel `expand_v4`, ops/frame_step.py): every frontier token
    reads its packed arc row [2M] int32 (f16(w) << 16 | sil << 14 | pdf,
    then next state), looks up the acoustic score ll[b, pdf] and scores
    E = K*M candidates with order-preserving int32 cost keys;
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
(f32 weights), three stable torch sorts a selection, and eps_depth
epsilon-closure rounds over padded eps rows; records per level, [B, T, L,
K|R] a chunk.  Its four table lookups go through `gather_op`, the
`gather_rows` kernel (`gather_rows_plain` to compare on the same tensors).

Bit-parity notes: shifts that the source makes logical are taken after a
mask; the f16 weight is read from the top half-word without a saturating
cast; cost keys rely on int32 wraparound, which torch's int32 arithmetic
keeps; the candidate cost is rounded once after the f32 sum, as XLA's
fused multiply-add rounds it at any acoustic scale (ops/frame_step.py).

The JAX package's ragged bucket ladder (`_frame_step_v4_ragged`) is not
ported: it is bit-equal to the full-K step (tests/test_viterbi_v4.py).
Where the out-degree is above 16 (composed split graphs and word loops,
whose degree capping does not converge, or raw graphs), the source
switches to its CSR decoder; the port keeps the padded step over wider
rows, the same search as the source's padded step with `padded_max_out`
raised (tests/test_torch_kaldi_e2e.py holds the JSON to the source's CSR
decode), as long as the padded table stays within PADDED_MAX_SLOTS.  Still
raised (ROADMAP A12, the CSR decoder): a padded table above that bound, and
eps rounds over a state with more than 32 eps arcs (the source's vmapped
CSR `_eps_level`).  v4 over pdf ids of 15 bits or more (the source's v4 on
exact3 rows) raises too.  Lattice records are always written.
"""
from __future__ import annotations

import copy
import dataclasses
import heapq
import threading

import numpy as np
import torch

from ..graph.fst import EPSILON, DecodingGraph
from ..graph.lattice import to_host
from . import viterbi_v3
from .frame_step import (
    INF, KERNELS, PM_IDENT_FLAG, PM_MASK, SPEECH_BIT, TSIL_MASK, SelectScratch,
)
from .gather import gather_rows
# padded layout for any out-degree whose [S+1, M] table has at most 2^26
# slots (after prepare_graph_v4 with M=4 the degree is 4 or 8 on most
# graphs; the source's padded limit is 16, above which it takes its CSR
# decoder, not ported); dedup among the 2K cheapest candidates, the
# source's default
PADDED_MAX_SLOTS = 1 << 26
DEDUP_SLACK = 2.0
# v3 eps rounds read padded eps rows up to this out-degree (the source's
# bound; above it the source takes its CSR eps rounds, not ported), and
# expand the EPS_BUDGET cheapest eps-flagged tokens (the source's default)
MAX_PADDED_EPS_OUT = 32
EPS_BUDGET = 1024


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
    tables on `device`: the v4 step (packed16 rows) or the v3 step (exact3
    rows, eps rounds), chosen by `frame_step` ("auto", "v3" or "v4")."""

    def __init__(
        self,
        graph: DecodingGraph,
        params: DecodeParams,
        silence_pdfs=None,
        optimize_graph: bool = False,
        device="cuda",
        frame_step: str = "auto",
    ):
        if frame_step not in ("auto", "v3", "v4"):
            raise ValueError(f"frame_step must be 'auto', 'v3' or 'v4'; got {frame_step!r}")
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
        slots = (S + 1) * graph.max_em_out
        if not (0 < graph.max_em_out and slots <= PADDED_MAX_SLOTS):
            raise ValueError(
                f"the padded layout needs a table [S+1, max_em_out] of at most "
                f"{PADDED_MAX_SLOTS} slots (got S={S}, max_em_out={graph.max_em_out}); "
                "the CSR decoder is not ported (ROADMAP A12)"
            )
        if frame_step == "auto":
            frame_step = "v4" if self.eps_iters == 0 else "v3"
        if frame_step == "v4" and self.eps_iters != 0:
            raise ValueError(
                "frame_step='v4' needs an eps-free graph (got eps_depth="
                f"{self.eps_iters}); run with optimize_graph=True, or take the v3 step"
            )
        if self.eps_iters and graph.max_eps_out > MAX_PADDED_EPS_OUT:
            raise ValueError(
                f"a state has {graph.max_eps_out} eps arcs; the v3 eps rounds read padded "
                f"rows of at most {MAX_PADDED_EPS_OUT}, and the source's CSR eps rounds "
                "are not ported (ROADMAP A12)"
            )
        self.frame_step = frame_step
        self.M = max(graph.max_em_out, 1)
        self.E = K * self.M
        # lattice rows per frame, dedup prefix and eps sources, sized as the
        # source sizes them with its defaults (lattice_budget=None,
        # dedup_slack=2.0)
        Ee = max(128, min(K * max(graph.max_eps_out, 1), 1 << 18))
        self.R = min(max(self.K, min(2048, self.E)), self.E, self.K + Ee)
        self.K2 = max(self.K, int(np.ceil(DEDUP_SLACK * K)))
        self.Eb = max(1, min(K, EPS_BUDGET))
        self.final_cost = np.append(graph.final_cost, np.float32(np.inf)).astype(np.float32)
        self._final_cost_t = torch.as_tensor(self.final_cost, device=self.device)
        self._build_padded_tables()
        self._init_states, self._init_costs, self._init_prefixes = self._initial_closure()
        # the frame step's kernels; chip_smoke.py and the card tests swap in
        # frame_step.PLAIN (v4) and gather_rows_plain (v3) to compare each
        # kernel with its plain version on the same CUDA tensors
        self.step_ops = KERNELS
        self.gather_op = gather_rows
        self._select_scratch = SelectScratch()
        # recognizers of one model share this decoder: one chunk at a time
        # (the source serialises decode_chunk the same way)
        self._dispatch_lock = threading.RLock()

    # ------------------------------------------------------------------ init

    def _build_padded_tables(self) -> None:
        """Dense [S+1, M] arc layout packed into one int32 row per state.
        v4, packed16 (2 planes):
          plane1 = f16(w) << 16 | sil << 14 | pdf   (pdf_bits <= 14)
          plane2 = next state | bit 30 if the target has epsilon arcs
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
        self.Me = 0
        if self.frame_step == "v3":
            self._build_exact3_tables(w, nsf, pdf, sil, ola, has_eps)
            return
        if self.pdf_bits > 14:
            raise ValueError(
                f"packed16 rows hold pdf ids below 2^14 (got {self.pdf_bits} "
                "bits); the v4 step on exact3 rows is not ported (ROADMAP A17)"
            )
        w16 = w.astype(np.float16).view(np.uint16).astype(np.uint32)
        p1 = ((w16 << 16) | (sil.astype(np.uint32) << 14) | pdf.astype(np.uint32))
        self.em_pack = torch.as_tensor(
            np.concatenate([p1.view(np.int32), nsf], axis=1), device=self.device
        )
        self.dense_w = w.astype(np.float16).astype(np.float32)

    def _build_exact3_tables(self, w, nsf, pdf, sil, ola, has_eps) -> None:
        """The v3 step's rows (source `_build_padded_tables`, exact3 pack
        and eps tables, :356-365 and :380-404)."""
        g, S, pb = self.graph, self.S, self.pdf_bits
        self.ol_in_meta = int(ola.max()) < (1 << (32 - (pb + 1)))
        meta = (sil.astype(np.uint32) << pb) | pdf.astype(np.uint32)
        if self.ol_in_meta:
            meta |= ola.astype(np.uint32) << (pb + 1)
        planes = [w.view(np.int32), nsf, meta.view(np.int32)]
        if not self.ol_in_meta:
            planes.append(ola)
        self.em_pack = torch.as_tensor(np.concatenate(planes, axis=1), device=self.device)
        self.dense_w = w
        if not self.eps_iters:
            return
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

    def to(self, device) -> "BatchViterbi":
        """The same decoder with its device tables on `device` (host views
        and the prepared graph are shared, not rebuilt)."""
        c = copy.copy(self)
        c.device = torch.device(device)
        for k in ("em_pack", "eps_pack", "_final_cost_t"):
            if hasattr(self, k):
                setattr(c, k, getattr(self, k).to(c.device))
        c._dispatch_lock = threading.RLock()
        c._select_scratch = SelectScratch()
        return c

    def init_frontier(self, batch: int) -> dict:
        dev = self.device
        return {
            "state": torch.as_tensor(self._init_states, device=dev).repeat(batch, 1),
            "cost": torch.as_tensor(self._init_costs, device=dev).repeat(batch, 1),
            # packed trailing-silence count + has-speech bit per token
            "tsil": torch.zeros((batch, self.K), dtype=torch.int32, device=dev),
        }

    # ------------------------------------------------------------- v4 step

    def _frame_step_v4(self, frontier, ll, valid, out):
        """One whole-batch frame step: expand, then select.  ll: [B, P]
        (rows may be strided); valid: [B] bool.  Returns (frontier, records
        {pm, state, f_cost} [B, K] and {lat_pm, lat_cost} [B, R]), the
        records written into `out` ({name: [B, K|R]})."""
        cbits, nsm, pm = self.step_ops.expand(
            self.em_pack, frontier["state"], frontier["cost"], ll,
            self.params.acoustic_scale, self.S, self.M, self.mbits)
        return self.step_ops.select(
            cbits, nsm, pm, frontier, valid, self.params.beam, self.params.lattice_beam,
            self.S, self.mbits, self.K2, self.R, out, scratch=self._select_scratch)

    # ------------------------------------------------------------- chunk API

    def record_lead(self, T: int, B: int) -> tuple:
        """The leading dims of one chunk's records: (T, B) for v4, the
        source's (B, T) for v3."""
        return (T, B) if self.frame_step == "v4" else (B, T)

    def record_buffers(self, lead: tuple, device=None) -> dict:
        """Uninitialised record planes on `device` (the decoder's by
        default): v4 {name: [*lead, K or R]}, v3 {name: [*lead, L, K or R]}
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

    def decode_chunk(self, frontier, loglikes, valid=None, out=None):
        """loglikes: [B, T, P] float32; valid: [B, T] bool.  Returns
        (frontier, records, best cost [B], best final cost [B]), all on the
        decoder's device; records are {name: [T, B, K or R]} (v4) or {name:
        [B, T, L, K or R]} (v3).  out: optional preallocated records
        (`record_buffers(record_lead(T, B))` or views of a larger buffer) to
        write into instead of allocating."""
        B, T, _ = loglikes.shape
        dev = loglikes.device
        if valid is None:
            valid = torch.ones((B, T), dtype=torch.bool, device=dev)
        with self._dispatch_lock:
            recs = out if out is not None else self.record_buffers(self.record_lead(T, B), dev)
            ll32 = loglikes.to(torch.float32)
            if self.frame_step == "v4":
                for t in range(T):
                    # frame t of the chunk read in place; records written at t
                    frontier, _ = self._frame_step_v4(
                        frontier, ll32[:, t], valid[:, t], {k: v[t] for k, v in recs.items()})
            else:
                # the v3 lookups read contiguous ll rows: one copy a chunk
                ll_t = ll32.transpose(0, 1).contiguous()
                for t in range(T):
                    frontier = viterbi_v3.frame_step_v3(
                        self, frontier, ll_t[t], valid[:, t], {k: v[:, t] for k, v in recs.items()})
            best_cost = frontier["cost"].amin(dim=1)
            final_tot = frontier["cost"] + self._final_cost_t[frontier["state"].long()]
            return frontier, recs, best_cost, final_tot.amin(dim=1)

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

    # the padded layout's em-level lattice records store the in-row arc slot
    # m; hosts reconstruct the dense arc id as prev_state * M + m
    lat_arc_is_m = True

    def host_em_arc(self, ai: int) -> tuple[float, int, int]:
        """(graph_weight, olabel, pdf) of a dense emitting-arc id."""
        s, m = divmod(int(ai), self.M)
        return (
            float(self.dense_w[s, m]),
            int(self.dense_olabel[s, m]),
            int(self.dense_pdf[s, m]),
        )

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
