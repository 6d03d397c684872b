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
import torch.nn.functional as F

from ..graph.lattice import to_host
from .frame_step import BIG_I32, INF, NS_MASK, SPEECH_BIT, TSIL_MASK, bits_cost, cost_bits, sub_scaled

# padded next-state field: bit 30 flags "target state has epsilon arcs", so
# the eps rounds know their sources without a graph lookup
EPS_NS_FLAG = 1 << 30
K_PLANES = {"prev": torch.int32, "olabel": torch.int32, "pdf": torch.int32,
            "f_state": torch.int32, "f_cost": torch.float32}
R_PLANES = {"lat_ns": torch.int32, "lat_prev": torch.int32, "lat_arc": torch.int32,
            "lat_cost": torch.float32}


def _fit(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """The first n columns of x, padded with `fill` when x has fewer."""
    if x.shape[1] >= n:
        return x[:, :n]
    return F.pad(x, (0, n - x.shape[1]), value=fill)


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
    lat = [_fit(x, R, f) for x, f in zip(sA, fills)]
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
    sC = [_fit(x, K, f) for x, f in zip(sC, fills)]
    return sC[0], sC[1], sC[2:], lat


def expand_candidates(dec, tok_state, tok_cost, ll):
    """Tokens -> scored candidates (cbits, nsm, prevm, metam, olab or None),
    each [B, K*M] (source `_expand_candidates`).  ll [B, P] contiguous.  The
    cost (tok + w) - scale * ac is rounded once, as XLA's fused
    multiply-add rounds it."""
    M, S = dec.M, dec.S
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
    prevm = (((e // M) << dec.mbits) | (e % M))[None, :].expand(B, E)
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


def frame_step_v3(dec, frontier, ll, valid, out):
    """One whole-batch v3 frame: expand, select, the eps rounds, identity
    rows for masked channels.  ll [B, P] contiguous; valid [B] bool; out:
    {name: [B, L, K|R]} record views written in place.  Returns the new
    frontier (freshly allocated)."""
    K, S, R, mbits, pb = dec.K, dec.S, dec.R, dec.mbits, dec.pdf_bits
    tok_state, tok_cost, tok_tsil = frontier["state"], frontier["cost"], frontier["tsil"]
    B = tok_state.shape[0]
    cbits, nsm, prevm, metam, olab = expand_candidates(dec, tok_state, tok_cost, ll)
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
        cur, rec = eps_level(dec, *cur)
        levels.append(rec)

    vb = valid[:, None]
    slot = torch.arange(max(K, R), dtype=torch.int32, device=tok_state.device)[None, :]
    ident = {
        "prev": slot[:, :K], "olabel": 0, "pdf": -1, "f_state": tok_state, "f_cost": tok_cost,
        "lat_ns": _fit(tok_state, R, S), "lat_prev": torch.where(slot < K, slot, -1)[:, :R],
        "lat_arc": -1, "lat_cost": _fit(tok_cost, R, INF),
    }
    for lvl, rec in enumerate(levels):
        for k, v in rec.items():
            out[k][:, lvl].copy_(torch.where(vb, v, ident[k]))
    return {"state": torch.where(vb, cur[0], tok_state),
            "cost": torch.where(vb, cur[1], tok_cost),
            "tsil": torch.where(vb, cur[2], tok_tsil)}


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
