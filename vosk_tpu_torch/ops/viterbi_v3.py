"""The v3 frame step of `BatchViterbi` (ops/viterbi.py): exact3 arc rows and
epsilon-closure rounds, for graphs that keep epsilon arcs.

Port of `vosk_tpu/ops/viterbi.py` `_frame_step_batched` and what it calls:
`_expand_candidates` (:641-682), `_select_v3` (:549-606),
`_finish_from_candidates` (:684-819), `_eps_level_batched` (:1157-1249),
and the v3 branch of `traceback_with_frames` (:1662-1709).  Per frame, for
each channel:
  * expand: every frontier token reads its exact3 row [3M or 4M] int32 (f32
    weight bits, next state | EPS_NS_FLAG, meta = olabel << (pdf_bits+1) |
    sil << pdf_bits | pdf, and the olabel in a 4th plane when it does not
    fit in meta), looks up ll[b, pdf] and scores E = K*M candidates;
  * select: a stable sort of the pool by cost (its R cheapest are the
    lattice rows), a stable sort of the K2 cheapest by (next state, cost)
    whose first of each state is the winner, a stable sort of the winners
    by cost; then the beam prune and the trailing-silence update;
  * eps rounds (eps_depth of them): the Eb cheapest eps-flagged tokens read
    their padded eps rows [4Me]; the frontier as identity candidates plus
    their eps targets go through the same selection.
Records are per level, {prev, olabel, pdf, f_state, f_cost} [B, L, K] and
{lat_ns, lat_prev, lat_arc, lat_cost} [B, L, R], L = 1 + eps_iters; a chunk's
are [B, T, L, K|R], the source's layout.  Masked channels keep identity
rows on every level.

The sorts are the source's XLA sorts, here `torch.sort(stable=True)` plus
gathers: the two-key sort is one stable sort of the int64 key (state << 32)
| (cost key + 2^31), and the source's `top_k` over the eps sources is the
first Eb of a stable ascending sort (top_k puts the lower index first among
equal keys).  The four table lookups the source makes with its Pallas
gather (ll[b, pdf] :669, tsil[b, prev] :716, state[b, src] :1181 through
`_small_gather`, tsil[b, prev] of an eps round :1222) go through
`dec.gather_op`: the `gather_rows` kernel by default, `gather_rows_plain`
to compare the two on the same CUDA tensors.  `gather_rows` copies bits, so
it equals both the source's f32 one-hot route and its 16-bit split.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.lattice import to_host
from ..parallel import mesh as pmesh
from . import viterbi_csr
from .viterbi_csr import fit, write_levels
from .frame_step import BIG_I32, INF, NS_MASK, SPEECH_BIT, TSIL_MASK, bits_cost, cost_bits, sub_scaled

# padded next-state field: bit 30 flags "target state has epsilon arcs", so
# the eps rounds know their sources without a graph lookup
EPS_NS_FLAG = 1 << 30
K_PLANES = {"prev": torch.int32, "olabel": torch.int32, "pdf": torch.int32,
            "f_state": torch.int32, "f_cost": torch.float32}
R_PLANES = {"lat_ns": torch.int32, "lat_prev": torch.int32, "lat_arc": torch.int32,
            "lat_cost": torch.float32}
# the sharded search (v4 and v3 steps): the mesh axis its expansion is
# sharded over, and each rank's contribution to the merged pool in frontier
# slots of its stripe (the source's defaults, which no caller changes)
SHARD_AXIS = "model"
SHARD_SLACK = 2


def select_v3(dec, cbits, nsf, pays):
    """Dedup by next state + top-K from one cost-ordered sort (source
    `_select_v3`).  cbits [B, N] order-encoded costs (BIG for masked), nsf
    [B, N] flagged next states (S for masked), pays: int32 payloads [B, N].
    Returns (kbits [B, K], nsf_k [B, K], payloads [B, K], lattice prefix:
    the R cheapest (cbits, nsf, *pays) rows)."""
    B, N = cbits.shape
    K, R, S = dec.K, dec.R, dec.S
    K2 = min(N, dec.K2)
    fills = (BIG_I32, S, -1, -1, -1)
    sA_c, order = torch.sort(cbits, dim=1, stable=True)
    order = order[:, :max(min(N, R), K2)]
    sA = [sA_c[:, :order.shape[1]]] + [torch.gather(x, 1, order) for x in (nsf, *pays)]
    lat = [fit(x, R, f) for x, f in zip(sA, fills)]
    # the K2 cheapest by (next state, cost): one stable sort of an int64 key
    c2, n2 = sA[0][:, :K2], sA[1][:, :K2]
    _, o = torch.sort((n2.long() << 32) | (c2.long() + 2**31), dim=1, stable=True)
    sB = [torch.gather(x[:, :K2], 1, o) for x in (n2, c2, *sA[2:])]
    first = torch.ones_like(sB[0], dtype=torch.bool)
    first[:, 1:] = sB[0][:, 1:] != sB[0][:, :-1]
    alive = first & (sB[0] != S) & (sB[1] < BIG_I32)
    kC, o2 = torch.sort(torch.where(alive, sB[1], BIG_I32), dim=1, stable=True)
    sC = [kC] + [torch.gather(x, 1, o2) for x in (sB[0], *sB[2:])]
    # tiny graphs: a pool smaller than max_active is padded to K
    sC = [fit(x, K, f) for x, f in zip(sC, fills)]
    return sC[0], sC[1], sC[2:], lat


def expand_candidates(dec, tok_state, tok_cost, ll, slot_base=0, slot_stride=1):
    """Tokens -> scored candidates (cbits, nsm, prevm, metam, olab or None),
    each [B, Kn*M] (source `_expand_candidates`, :641-682), from the stripe
    of frontier slots slot_base + j * slot_stride (the whole frontier by
    default; prevm carries the global slot).  ll [B, P] contiguous.  The
    cost (tok + w) - scale * ac is rounded once, as XLA's fused
    multiply-add rounds it."""
    M, S = dec.M, dec.S
    tok_state = tok_state[:, slot_base::slot_stride]
    tok_cost = tok_cost[:, slot_base::slot_stride]
    B, K = tok_state.shape
    E = K * M
    rows = dec.em_pack[tok_state.long()]  # [B, K, 3M or 4M]

    def plane(i):
        return rows[:, :, i * M:(i + 1) * M].reshape(B, E)

    w = plane(0).view(torch.float32)
    nsf, meta = plane(1), plane(2)
    pdf = meta & ((1 << dec.pdf_bits) - 1)
    ac = dec.gather_op(ll, pdf)  # source :669
    cost = sub_scaled(tok_cost.repeat_interleave(M, dim=1) + w, dec.params.acoustic_scale, ac)
    mask = torch.isfinite(w)
    e = torch.arange(E, dtype=torch.int32, device=rows.device)
    prevm = ((((e // M) * slot_stride + slot_base) << dec.mbits) | (e % M))[None, :].expand(B, E)
    olab = None if dec.ol_in_meta else torch.where(mask, plane(3), 0)
    return (torch.where(mask, cost_bits(cost), BIG_I32), torch.where(mask, nsf, S), prevm,
            torch.where(mask, meta, 0), olab)


def _lattice_rows(dec, lat, kept_cost, lat_prev, lat_arc):
    """The lattice planes of a level: prefix rows within lattice-beam of the
    WORST surviving winner (every selected token keeps its inbound arc; the
    final pruning is retrospective)."""
    lat_cb = lat[0]
    lat_cost = bits_cost(lat_cb)
    wk = torch.where(torch.isfinite(kept_cost), kept_cost, -INF).amax(dim=1, keepdim=True)
    lkeep = (lat_cb < BIG_I32) & (lat_cost <= wk + dec.params.lattice_beam)
    return {
        "lat_ns": torch.where(lkeep, lat[1] & NS_MASK, dec.S),
        "lat_prev": torch.where(lkeep, lat_prev, -1),
        "lat_arc": torch.where(lkeep, lat_arc, -1),
        "lat_cost": torch.where(lkeep, lat_cost, INF),
    }


def _prune(dec, kbits, nsf_k):
    """Beam prune about the best winner: (keep, state, cost, eps flag)."""
    cost = bits_cost(kbits)
    keep = (kbits < BIG_I32) & (kbits <= cost_bits(cost[:, :1] + dec.params.beam))
    return (keep, torch.where(keep, nsf_k & NS_MASK, dec.S), torch.where(keep, cost, INF),
            keep & ((nsf_k & EPS_NS_FLAG) != 0))


def eps_level(dec, cur_state, cur_cost, cur_tsil, eflag):
    """One whole-batch epsilon-closure round (source `_eps_level_batched`):
    the best Eb eps-flagged tokens expand their eps arcs; frontier tokens
    ride along as identity candidates; eps moves consume no frame, so tsil
    carries over from the source slot.  Returns ((state, cost, tsil, eflag),
    level records)."""
    K, Me, S, Eb = dec.K, dec.Me, dec.S, dec.Eb
    B = cur_state.shape[0]
    dev = cur_state.device
    src_key = torch.where(eflag, cost_bits(cur_cost), BIG_I32)
    src_cb, src = torch.sort(src_key, dim=1, stable=True)
    src_cb, src = src_cb[:, :Eb], src[:, :Eb].contiguous().int()
    src_alive = src_cb < BIG_I32
    src_state = dec.gather_op(cur_state, src)  # source :1181
    rows = dec.eps_pack[torch.where(src_alive, src_state, S).long()]  # [B, Eb, 4Me]

    def plane(i):
        return rows[:, :, i * Me:(i + 1) * Me].reshape(B, Eb * Me)

    w = plane(0).view(torch.float32)
    ecost = bits_cost(src_cb).repeat_interleave(Me, dim=1) + w
    emask = torch.isfinite(w) & src_alive.repeat_interleave(Me, dim=1)
    slot = torch.arange(K, dtype=torch.int32, device=dev)[None, :].expand(B, K)
    id_nsf = torch.where(cur_state == S, S,
                         torch.where(eflag, cur_state | EPS_NS_FLAG, cur_state))
    kbits, nsf_k, pays_k, lat = select_v3(
        dec,
        torch.cat([cost_bits(cur_cost), torch.where(emask, cost_bits(ecost), BIG_I32)], dim=1),
        torch.cat([id_nsf, torch.where(emask, plane(1), S)], dim=1),
        (torch.cat([slot, src.repeat_interleave(Me, dim=1)], dim=1),
         torch.cat([torch.zeros_like(slot), torch.where(emask, plane(2), 0)], dim=1),
         torch.cat([torch.full_like(slot, -1), torch.where(emask, plane(3), -1)], dim=1)))
    keep2, st2, c2, eflag2 = _prune(dec, kbits, nsf_k)
    prev_k = torch.where(keep2, pays_k[0], 0)
    ts2 = torch.where(keep2, dec.gather_op(cur_tsil, prev_k), 0)  # source :1222
    rec = {
        "prev": torch.where(keep2, prev_k, -1),
        "olabel": torch.where(keep2, pays_k[1], 0),
        "pdf": torch.full_like(prev_k, -1),
        "f_state": st2,
        "f_cost": c2,
        **_lattice_rows(dec, lat, c2, lat[2], lat[4]),
    }
    return (st2, c2, ts2, eflag2), rec


def shard_coordinate(mesh) -> tuple[int, int]:
    """(i, n): this rank's coordinate on SHARD_AXIS and the axis' size; the
    rank expands frontier slots i, i + n, ...."""
    return mesh.get_local_rank(SHARD_AXIS), pmesh.axis_size(mesh, SHARD_AXIS)


def shard_candidates(dec, mesh, cbits, pays, Kn):
    """A rank's share of the sharded search's candidate pool, merged over
    the mesh's SHARD_AXIS (source `_frame_step_sharded` :1459-1491 and
    `_frame_step_v4_sharded` :1519-1530): the beam threshold from the
    channel's best candidate over every rank (a MIN all-reduce of the
    order-preserving keys), then this rank's C = min(E, SHARD_SLACK * Kn)
    cheapest candidates (a stable sort), keyed BIG past the threshold, and
    every rank's C gathered in rank order.  cbits, each of pays: [B, E]
    int32 from this rank's stripe of Kn tokens.  Returns (cbits, *pays),
    each [B, n * C].

    The source masks before its sort; masking the sorted prefix keeps the
    same keys in the same order (the masked ones sort last either way), and
    the payload of a BIG key is never read: nsm and pm are defined where
    cbits < BIG (`frame_step.expand_v4` leaves them unwritten elsewhere).
    The best key is the first of the sorted row, so no separate minimum is
    taken."""
    C = min(cbits.shape[1], SHARD_SLACK * Kn)
    cb, order = torch.sort(cbits, dim=1, stable=True)
    cb, order = cb[:, :C], order[:, :C]
    best = pmesh.all_reduce_min(mesh, SHARD_AXIS, cb[:, 0].contiguous())
    thresh = cost_bits(bits_cost(best) + dec.params.beam)
    planes = torch.stack([torch.where(cb <= thresh[:, None], cb, BIG_I32),
                          *(torch.gather(p, 1, order) for p in pays)])
    return pmesh.all_gather_cat(mesh, SHARD_AXIS, planes, dim=2).unbind(0)


def frame_step_v3(dec, frontier, ll, valid, out, mesh=None):
    """One whole-batch v3 frame: expand, select, the eps rounds, identity
    rows for masked channels.  ll [B, P] contiguous; valid [B] bool; out:
    {name: [B, L, K|R]} record views written in place.  Returns the new
    frontier (freshly allocated).  mesh: None, or the mesh of the sharded
    search (source `_frame_step_sharded`, :1441-1492): this rank expands its
    stripe of the frontier and finishes the merged pool of
    `shard_candidates`, unsorted, as the source does."""
    if mesh is None:
        cands = expand_candidates(dec, frontier["state"], frontier["cost"], ll)
    else:
        i, n = shard_coordinate(mesh)
        cbits, *pays, olab = expand_candidates(dec, frontier["state"], frontier["cost"], ll,
                                               i, n)
        pool = shard_candidates(dec, mesh, cbits, pays + [olab] * (olab is not None),
                                dec.K // n)
        cands = (*pool, None) if olab is None else tuple(pool)
    return finish_from_candidates(dec, frontier, cands, valid, out)


def finish_from_candidates(dec, frontier, cands, valid, out):
    """Selection, records and eps rounds from a scored candidate pool
    (cbits, nsm, prevm, metam, olab or None), each [B, N] (source
    `_finish_from_candidates`, :684-819).  Returns the new frontier."""
    mbits, pb = dec.mbits, dec.pdf_bits
    tok_tsil = frontier["tsil"]
    cbits, nsm, prevm, metam, olab = cands
    kbits, nsf_k, pays_k, lat = select_v3(
        dec, cbits, nsm, (prevm, metam) + (() if olab is None else (olab,)))
    keep, new_state, new_cost, eflag = _prune(dec, kbits, nsf_k)
    prevm_k, meta_k = pays_k[0], pays_k[1]
    prev = torch.where(keep, prevm_k >> mbits, 0)
    sil = ((meta_k >> pb) & 1) != 0
    # the source's logical shift, taken after a mask (meta may use bit 31)
    olab_k = (meta_k >> (pb + 1)) & ((1 << (31 - pb)) - 1) if dec.ol_in_meta else pays_k[2]
    # trailing silence: silence arcs extend the source token's run, speech
    # arcs reset it and latch the speech bit
    prev_ts = dec.gather_op(tok_tsil, prev)  # source :716
    cand_ts = torch.where(sil, ((prev_ts & TSIL_MASK) + 1) | (prev_ts & SPEECH_BIT), SPEECH_BIT)
    mmask = (1 << mbits) - 1
    levels = [{
        "prev": torch.where(keep, prev, -1),
        "olabel": torch.where(keep, olab_k, 0),
        "pdf": torch.where(keep, meta_k & ((1 << pb) - 1), -1),
        "f_state": new_state,
        "f_cost": new_cost,
        # em-level lat_arc is the in-row arc slot m; hosts rebuild the dense
        # arc id as prev_state * M + m
        **_lattice_rows(dec, lat, new_cost, lat[2] >> mbits, lat[2] & mmask),
    }]
    cur = (new_state, new_cost, torch.where(keep, cand_ts, 0), eflag)
    for _ in range(dec.eps_iters):
        if dec.Me:
            cur, rec = eps_level(dec, *cur)
        else:
            # a state with more than 32 eps arcs: the source's CSR eps rounds
            # (:762-769); their eps flags are not read again
            cur, rec = viterbi_csr.eps_level(dec, *cur[:3])
        levels.append(rec)
    return write_levels(dec, frontier, levels, cur, valid, out)


def traceback_v3(dec, records, frontier, channel, use_final=True, at_start=True):
    """Best-path traceback over v3 records ({prev, olabel, pdf} [B, T, L, K]
    per chunk): (cost, [(olabel, frame_idx)], pdf alignment), frames
    counted on level 0 of valid frames.  The olabel and pdf ride inline, so
    no fold-boundary state row is needed."""
    slot, best_cost = dec.best_slot(frontier, channel, use_final)
    if slot is None:
        return np.inf, [], []

    # total valid frames = count of level-0 records with pdf >= 0 along the
    # path; the first pass collects raw entries, then frames are numbered
    raw: list[tuple[int, bool, int]] = []  # (olabel, is_frame_level, pdf)
    for rec in reversed(records):
        prev = to_host(rec["prev"][channel])  # [T, L, K]
        olab = to_host(rec["olabel"][channel])
        pdf = to_host(rec["pdf"][channel])
        T, L, _ = prev.shape
        for t in range(T - 1, -1, -1):
            for lvl in range(L - 1, -1, -1):
                if slot < 0:
                    return best_cost, [], []
                raw.append((int(olab[t, lvl, slot]), lvl == 0, int(pdf[t, lvl, slot])))
                slot = int(prev[t, lvl, slot])

    n_valid = sum(1 for _, isf, p in raw if isf and p >= 0)
    pdfs = [0] * n_valid
    ols_frames: list[tuple[int, int]] = []
    fidx = n_valid  # walking backwards; the current frame is fidx - 1
    for ol, is_frame, p in raw:
        if ol != 0:
            ols_frames.append((ol, max(fidx - 1, 0)))
        if is_frame and p >= 0:
            fidx -= 1
            pdfs[fidx] = p
    # the initial closure's olabel prefix of the starting slot (frame 0),
    # skipped when the records do not reach utterance start (a folded window)
    if at_start and 0 <= slot < len(dec._init_prefixes):
        for ol in reversed(dec._init_prefixes[slot]):
            ols_frames.append((ol, 0))
    ols_frames.reverse()
    return best_cost, ols_frames, pdfs
