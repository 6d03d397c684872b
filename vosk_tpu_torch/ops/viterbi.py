"""Batched WFST token-passing beam search in PyTorch: the v4 frame step.

Port of `vosk_tpu/ops/viterbi.py` `BatchViterbi` for the single-phase v4
step over eps-free padded graphs with packed16 arc rows (the step the JAX
package's runtime picks for graphs through `prepare_graph_v4`).  Given the
same log-likelihoods, the frontier and the five record planes are
bit-equal to the JAX decoder (tests/test_torch_viterbi.py).

Per frame, for each channel:
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
Records keep the [T, B, ...] layout of the source's scan.  `step_ops`
holds the two kernels' wrappers (`frame_step.KERNELS`, the pair
(expand, select)); setting it to `frame_step.PLAIN` runs their plain
versions on the same tensors.

Bit-parity notes: shifts that the source makes logical are taken after a
mask; the f16 weight is read from the top half-word without a saturating
cast; cost keys rely on int32 wraparound, which torch's int32 arithmetic
keeps; the candidate cost is rounded once after the f32 sum, as XLA's
fused multiply-add rounds it at any acoustic scale (ops/frame_step.py).

The JAX package's ragged bucket ladder (`_frame_step_v4_ragged`) is not
ported: it is bit-equal to the full-K step (tests/test_viterbi_v4.py).
Where `prepare_graph_v4` leaves an out-degree above 16 (composed split
graphs and word loops, whose degree capping does not converge), the source
switches to its CSR decoder; the port keeps the v4 step over wider padded
rows, the same search as the source's v4 step with `padded_max_out`
raised (tests/test_torch_kaldi_e2e.py holds the JSON to the source's CSR
decode), as long as the padded table stays within PADDED_MAX_SLOTS.
Graphs that are not v4-eligible (epsilon rounds, a padded table above that
bound, pdf ids of 15 bits or more) raise.  Lattice records are always
written.
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
from .frame_step import (
    INF, KERNELS, PM_IDENT_FLAG, PM_MASK, SPEECH_BIT, TSIL_MASK, SelectScratch,
)
# padded layout for any out-degree whose [S+1, M] table has at most 2^26
# slots (after prepare_graph_v4 with M=4 the degree is 4 or 8 on most
# graphs; the source's padded limit is 16, above which it takes its CSR
# decoder, not ported); dedup among the 2K cheapest candidates, the
# source's default
PADDED_MAX_SLOTS = 1 << 26
DEDUP_SLACK = 2.0


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
    """Channel-batched streaming Viterbi over one decoding graph (v4 step,
    packed16 arc rows), with its tables on `device`."""

    def __init__(
        self,
        graph: DecodingGraph,
        params: DecodeParams,
        silence_pdfs=None,
        optimize_graph: bool = False,
        device="cuda",
    ):
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
        eps_iters = graph.eps_depth if graph.num_eps_arcs > 0 else 0
        slots = (S + 1) * graph.max_em_out
        if not (0 < graph.max_em_out and slots <= PADDED_MAX_SLOTS) or eps_iters != 0:
            raise ValueError(
                "the v4 step needs an eps-free graph whose padded table "
                f"[S+1, max_em_out] has at most {PADDED_MAX_SLOTS} slots (got "
                f"S={S}, max_em_out={graph.max_em_out}, eps_depth={eps_iters}); "
                "run with optimize_graph=True.  The v3 and CSR decoders are not "
                "ported (ROADMAP A9, A12)"
            )
        self.M = max(graph.max_em_out, 1)
        self.E = K * self.M
        # lattice rows per frame and dedup prefix, sized as the source sizes
        # them with its defaults (lattice_budget=None, dedup_slack=2.0)
        Ee = max(128, min(K * max(graph.max_eps_out, 1), 1 << 18))
        self.R = min(max(self.K, min(2048, self.E)), self.E, self.K + Ee)
        self.K2 = max(self.K, int(np.ceil(DEDUP_SLACK * K)))
        self.final_cost = np.append(graph.final_cost, np.float32(np.inf)).astype(np.float32)
        self._final_cost_t = torch.as_tensor(self.final_cost, device=self.device)
        self._build_padded_tables()
        self._init_states, self._init_costs, self._init_prefixes = self._initial_closure()
        # the frame step's kernels; chip_smoke.py and the card tests swap in
        # frame_step.PLAIN to compare the two on the same CUDA tensors
        self.step_ops = KERNELS
        self._select_scratch = SelectScratch()
        # recognizers of one model share this decoder: one chunk at a time
        # (the source serialises decode_chunk the same way)
        self._dispatch_lock = threading.RLock()

    # ------------------------------------------------------------------ init

    def _build_padded_tables(self) -> None:
        """Dense [S+1, M] arc layout packed into one int32 row per state:
          plane1 = f16(w) << 16 | sil << 14 | pdf   (pdf_bits <= 14)
          plane2 = next state | bit 30 if the target has epsilon arcs
        Pad slots: w=+inf, next=S.  Host-side dense views (arc id = state*M
        + m, f16-rounded weights) serve traceback and lattice finishing."""
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
        if g.num_eps_arcs > 0:
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
        if self.pdf_bits > 14:
            raise ValueError(
                f"packed16 rows hold pdf ids below 2^14 (got {self.pdf_bits} "
                "bits); the exact3 pack is not ported"
            )
        w16 = w.astype(np.float16).view(np.uint16).astype(np.uint32)
        p1 = ((w16 << 16) | (sil.astype(np.uint32) << 14) | pdf.astype(np.uint32))
        self.em_pack = torch.as_tensor(
            np.concatenate([p1.view(np.int32), nsf], axis=1), device=self.device
        )
        self.dense_w = w.astype(np.float16).astype(np.float32)
        self.dense_next, self.dense_pdf, self.dense_olabel = nxt, pdf, ola
        # candidate slot e = prev*M + m carries pm = prev << mbits | m
        self.mbits = max((M - 1).bit_length(), 1)

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
        for k in ("em_pack", "_final_cost_t"):
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

    def record_buffers(self, lead: tuple, device=None) -> dict:
        """Uninitialised record planes {name: [*lead, K or R]} on `device`
        (the decoder's by default); `lead` is (T, B) for one chunk."""
        dev = self.device if device is None else device
        shapes = {"pm": (torch.int32, self.K), "state": (torch.int32, self.K),
                  "f_cost": (torch.float32, self.K),
                  "lat_pm": (torch.int32, self.R),
                  "lat_cost": (torch.float32, self.R)}
        return {k: torch.empty((*lead, n), dtype=dt, device=dev)
                for k, (dt, n) in shapes.items()}

    def decode_chunk(self, frontier, loglikes, valid=None, out=None):
        """loglikes: [B, T, P] float32; valid: [B, T] bool.  Returns
        (frontier, records {name: [T, B, K or R]}, best cost [B], best final
        cost [B]), all on the decoder's device.  out: optional preallocated
        records (`record_buffers((T, B))` or views of a larger buffer) to
        write into instead of allocating."""
        B, T, _ = loglikes.shape
        dev = loglikes.device
        if valid is None:
            valid = torch.ones((B, T), dtype=torch.bool, device=dev)
        with self._dispatch_lock:
            recs = out if out is not None else self.record_buffers((T, B), dev)
            ll32 = loglikes.to(torch.float32)
            for t in range(T):
                # frame t of the chunk read in place; records written at t
                frontier, _ = self._frame_step_v4(
                    frontier, ll32[:, t], valid[:, t], {k: v[t] for k, v in recs.items()})
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

    def traceback_with_frames(
        self, records, frontier, channel, use_final=True, at_start=True,
        init_states=None,
    ):
        """Best-path traceback for v4 records ({pm, state} each [T, B, K]):
        (cost, [(olabel, frame_idx)], pdf alignment).  Copy of the source's
        `_traceback_v4`; reads one channel's rows to the host.

        olabel/pdf/weight come from the host dense views keyed by
        (source state, arc slot m); the device never writes them.
        init_states anchors frame 0's arc sources at a fold boundary
        (at_start=False)."""
        if init_states is None:
            if not at_start:
                raise ValueError(
                    "v4 traceback with at_start=False needs init_states "
                    "(the fold-boundary frontier's state row)"
                )
            init_states = self._init_states
        state = to_host(frontier["state"][channel])
        cost = to_host(frontier["cost"][channel])
        fc = self.final_cost[state]
        tot = cost + fc
        if use_final and np.isfinite(tot).any():
            slot = int(np.argmin(tot))
            best_cost = float(tot[slot])
        else:
            slot = int(np.argmin(cost))
            best_cost = float(cost[slot])
        if not np.isfinite(cost[slot]):
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
