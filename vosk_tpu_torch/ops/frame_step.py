"""The v4 frame step's two kernels: expand, and select.

Per frame the decoder (ops/viterbi.py) runs
  * `expand_v4`: tokens -> scored candidates (cbits, nsm, pm), each
    [B, K*M]: the arc-row read (packed16 rows, or exact3 rows where pdf
    ids need 15 bits or more), the acoustic lookup ll[b, pdf] and the
    order-preserving cost keys in one pass (source:
    `vosk_tpu/ops/viterbi.py` `_unpack_rows_v4` + `_expand_v4`, :833-894);
    nsm and pm are defined where cbits < BIG;
  * `select_v4`: from that unsorted pool, the dedup by next state, the
    beam prune, the trailing-silence lookup tsil[b, prev], the new
    frontier and the five record planes, in two launches (a scan of the
    keys, then a thread-block cluster per channel: radix cuts, a hash
    table for the dedup, sorts of at most K and R keys) and no sort of the
    pool (source: the pool sort of `_frame_step_v4` :905 and
    `_select_v4`, :1057-1155).
Together they replace the JAX package's Pallas kernel `_pallas_gather`
(vosk_tpu/ops/gather.py:33) at its two v4 call sites (:879 and :1105), and
the sorts and element-wise ops that made its indices and consumed its
output.  The sharded v4 step (`_frame_step_v4_sharded`, :1494) reaches the
same sites: `expand_v4` takes a stripe of the frontier (`slot_base`,
`slot_stride`, read in place), and `select_v4` the merged pool of every
rank's best candidates, which is not K*M wide.

Each wrapper launches its hand-written Hopper kernel (csrc/frame_step.cu,
built with the other csrc/ sources into one library by ops/_kernels.py) on
CUDA tensors, and runs its plain PyTorch version on CPU tensors;
`<wrapper>.launches` counts kernel calls.  `KERNELS` and `PLAIN` bundle
the pairs for the decoder's `step_ops` hook.

The v4 decoder captures its chunk's frame steps in a CUDA graph
(ops/viterbi.py `decode_chunk`).  A wrapper called while its stream is
capturing records its launch and counts nothing; each replay of a T-frame
chunk adds T to both counts (`count_replay`), so the counts stay the
launches the device ran.  `GRAPH_COUNTS` counts the captures and replays.

Bit parity with the JAX decoder: XLA on the CPU contracts the source's
`(tok_cost + w) - scale * ac` into one fused multiply-add, so the cost is
rounded once after the f32 sum.  The kernel computes that FMA; the plain
version computes the difference exactly in float64, rounds it to odd and
casts once (53 >= 2 * 24 + 2 bits, so the cast rounds correctly).  The
selection's sorts are stable, as `lax.sort` is; the two-key sort is one
stable sort on the int64 key (state << 32) | (cost key + 2^31).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _kernels
from .gather import gather_rows_plain

INF = float("inf")
BIG_I32 = 2**31 - 1
_I32_MIN = -(2**31)
# per-token "tsil": trailing silence frame count (low bits) + has-speech flag
SPEECH_BIT = 1 << 21
TSIL_MASK = (1 << 21) - 1
# padded-layout next-state field: bit 30 flags "target has epsilon arcs"
NS_MASK = (1 << 30) - 1
# v4 record pm-plane flags: bit 30 = arc is silence (device-side only, not
# stored in records), bit 29 = identity carry (masked frame, no arc taken)
PM_SIL_FLAG = 1 << 30
PM_IDENT_FLAG = 1 << 29
PM_MASK = (1 << 29) - 1
RECORD_PLANES = ("pm", "state", "f_cost", "lat_pm", "lat_cost")


def cost_bits(cost: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 encoding of an f32 cost (a < b <=> bits(a) <
    bits(b)); +inf maps above all finite costs."""
    cb = cost.view(torch.int32)
    return torch.where(cb < 0, _I32_MIN - cb, cb)


def bits_cost(bits: torch.Tensor) -> torch.Tensor:
    raw = torch.where(bits < 0, _I32_MIN - bits, bits)
    return raw.view(torch.float32)


def sub_scaled(t: torch.Tensor, scale: float, ac: torch.Tensor) -> torch.Tensor:
    """f32 t - f32(scale) * ac rounded once, as a fused multiply-add gives it.

    The product is exact in float64 (24 + 24 bits); the difference d may not
    be, so d is rounded to odd with its exact TwoSum residual r before the
    one cast to f32.  Where t or ac is not finite, r is NaN and d is kept."""
    s = torch.tensor(scale, dtype=torch.float32).double()
    a = t.double()
    b = -(s * ac.double())
    d = a + b
    bb = d - a
    r = (a - (d - bb)) + (b - bb)
    even = (d.view(torch.int64) & 1) == 0
    step = (r != 0) & torch.isfinite(r) & even
    toward = torch.where(r > 0, INF, -INF).to(torch.float64)
    return torch.where(step, torch.nextafter(d, toward), d).to(torch.float32)


# ----------------------------------------------------------------- expand


def stripe_len(K: int, slot_base: int, slot_stride: int) -> int:
    """Tokens in the stripe slot_base, slot_base + slot_stride, ... of K slots."""
    if slot_base < 0 or slot_stride < 1:
        raise ValueError(f"stripe needs slot_base >= 0 and slot_stride >= 1; got "
                         f"{slot_base}, {slot_stride}")
    return max(0, -(-(K - slot_base) // slot_stride))


def expand_v4_plain(em_pack, tok_state, tok_cost, ll, acoustic_scale, S, M, mbits,
                    pdf_bits=None, slot_base=0, slot_stride=1):
    """Tokens -> scored candidates (cbits, nsm, pm), each [B, Kn*M] int32.

    em_pack: with pdf_bits None, [S+1, 2M] int32 packed16 rows (f16(w) << 16
    | sil << 14 | pdf, then next state); else [S+1, 3M] exact3 rows (f32
    weight bits, next state, meta = sil << pdf_bits | pdf; higher meta bits
    are ignored).  tok_state, tok_cost [B, K]: the frontier, whose stripe of
    slots slot_base + j * slot_stride (Kn of them, `stripe_len`) is expanded;
    the whole frontier by default.  ll [B, P] f32, any strides; a pdf >= P
    scores ac = 0.  Candidate e = j*M + m carries the global slot in pm
    (source `_expand_v4`, :865-893)."""
    stripe_len(tok_state.shape[1], slot_base, slot_stride)
    tok_state = tok_state[:, slot_base::slot_stride]
    tok_cost = tok_cost[:, slot_base::slot_stride]
    B, K = tok_state.shape
    E = K * M
    rows = em_pack[tok_state.long()]  # [B, K, 2M or 3M]
    p1 = rows[:, :, :M].reshape(B, E)
    nsf = rows[:, :, M:2 * M].reshape(B, E)
    if pdf_bits is None:
        # f16 weight bits = the top half-word of p1, brought into int16 range
        # by value (no saturating narrowing cast), then bit-viewed
        h = (p1 >> 16) & 0xFFFF
        w = torch.where(h >= 0x8000, h - 0x10000, h).to(torch.int16)
        w = w.view(torch.float16).to(torch.float32)
        sil = (p1 >> 14) & 1
        pdf = p1 & ((1 << 14) - 1)
    else:  # the source's exact3 arm (_unpack_rows_v4 :855-863)
        meta = rows[:, :, 2 * M:3 * M].reshape(B, E)
        w = p1.contiguous().view(torch.float32)
        sil = (meta >> pdf_bits) & 1  # logical: bit 31 is masked off
        pdf = meta & ((1 << pdf_bits) - 1)
    ac = gather_rows_plain(ll.contiguous(), pdf)
    cost = sub_scaled(tok_cost.repeat_interleave(M, dim=1) + w, acoustic_scale, ac)
    finite = torch.isfinite(w)
    cbits = torch.where(finite, cost_bits(cost), BIG_I32)
    nsm = torch.where(finite, nsf & NS_MASK, S)
    e = torch.arange(E, dtype=torch.int32, device=p1.device)
    prevm = (((e // M) * slot_stride + slot_base) << mbits) | (e % M)
    pm = prevm[None, :] + (sil << 30)
    return cbits, nsm, pm


def _check_2d(name, x, dtype, rows=None, cols=None):
    if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.dtype != dtype:
        raise TypeError(f"{name} must be a 2-D {dtype} tensor; got "
                        f"{getattr(x, 'dtype', type(x))} {tuple(getattr(x, 'shape', ()))}")
    if (rows is not None and x.shape[0] != rows) or (cols is not None and x.shape[1] != cols):
        raise ValueError(f"{name} has shape {tuple(x.shape)}; expected "
                         f"[{rows if rows is not None else '*'}, "
                         f"{cols if cols is not None else '*'}]")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} needs unit column stride; got strides {x.stride()}")


def _device_of(*xs) -> torch.device:
    dev = xs[0].device
    for x in xs[1:]:
        if x.device != dev:
            raise ValueError(f"tensors on {dev} and {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the frame step runs on cpu or cuda, not {dev}")
    return dev


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "vt_expand_v4": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _LL, _I, _I, _I, _I, _I, _I, _I,
                     _P, _P, _P, _I, _P],
    "vt_select_v4": [_P, _P, _P, _LL, _P, _P, _P, _P, _LL, _F, _F, _I, _I, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _kernel(name: str):
    """The C entry point `name` of the shared kernel library, typed."""
    return _kernels.function(name, _SIGNATURES[name])


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# how the expand kernel reads the ll row: staged by a bulk copy, or in place
EXPAND_STAGES = {"bulk": 0, "in_place": 1}


def expand_v4(em_pack, tok_state, tok_cost, ll, acoustic_scale, S, M, mbits, pdf_bits=None,
              stage=None, slot_base=0, slot_stride=1):
    """`expand_v4_plain` as one kernel launch on CUDA tensors (the plain
    version on CPU tensors), over packed16 rows (pdf_bits None) or exact3
    rows.  ll may be a row-strided view ([B, T, P] chunk at frame t).  The
    kernel reads the stripe slot_base, slot_base + slot_stride, ... in place
    from the whole frontier (no strided copy).  stage: None lets the kernel
    choose how it reads the ll row; a key of EXPAND_STAGES forces one (for
    measurement; a row longer than shared memory holds is read in place all
    the same).  `expand_v4.launches` counts kernel launches.

    The kernel writes what select reads: cbits for every candidate, and nsm
    and pm are defined where cbits < BIG (a real arc of a live token; a
    dead token's or padding arc's candidate leaves them unwritten).  The
    plain version writes (BIG, S, prevm) there, as the JAX package does."""
    _check_2d("tok_state", tok_state, torch.int32)
    B, row = tok_state.shape
    K = stripe_len(row, slot_base, slot_stride)
    if pdf_bits is not None and not 1 <= pdf_bits <= 31:
        raise ValueError(f"exact3 rows need pdf_bits in 1..31; got {pdf_bits}")
    if stage is not None and stage not in EXPAND_STAGES:
        raise ValueError(f"stage must be None or one of {list(EXPAND_STAGES)}; got {stage!r}")
    _check_2d("em_pack", em_pack, torch.int32, cols=(2 if pdf_bits is None else 3) * M)
    _check_2d("tok_cost", tok_cost, torch.float32, B, row)
    _check_2d("ll", ll, torch.float32, B)
    dev = _device_of(em_pack, tok_state, tok_cost, ll)
    if dev.type == "cpu":
        return expand_v4_plain(em_pack, tok_state, tok_cost, ll, acoustic_scale, S, M, mbits,
                               pdf_bits, slot_base, slot_stride)
    if not (em_pack.is_contiguous() and tok_state.is_contiguous() and tok_cost.is_contiguous()):
        raise ValueError("expand_v4 needs contiguous em_pack, tok_state and tok_cost")
    if em_pack.shape[0] != S + 1 or B > 65535 or K * M >= 2**31:
        raise ValueError(f"expand_v4 shape out of range: S={S} rows={em_pack.shape[0]} "
                         f"B={B} K={K} M={M}")
    out = [torch.empty((B, K * M), dtype=torch.int32, device=dev) for _ in range(3)]
    if B == 0 or K == 0:
        return tuple(out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("vt_expand_v4")(
            em_pack.data_ptr(), tok_state.data_ptr(), tok_cost.data_ptr(), ll.data_ptr(),
            ll.stride(0), ll.shape[1], float(acoustic_scale), B, K, row, slot_base,
            slot_stride, S, M, mbits, 2 if pdf_bits is None else 3, pdf_bits or 0,
            *(o.data_ptr() for o in out),
            -1 if stage is None else EXPAND_STAGES[stage],
            stream)
        capturing = torch.cuda.is_current_stream_capturing()
    _launched("expand_v4", err)
    if not capturing:
        expand_v4.launches += 1
    return tuple(out)


expand_v4.launches = 0

# ---------------------------------------------------------------- select


def select_v4_plain(cbits, nsm, pm, frontier, valid, beam, lattice_beam, S, mbits, K2, R, out,
                    scratch=None):
    """The v4 selection from the unsorted candidate pool of `expand_v4`.

    cbits, nsm, pm [B, E] int32 (candidate e = k*M + m); frontier {state,
    cost, tsil} [B, K]; valid [B] bool.  The source's three stable sorts:
    the pool by cost; its K2 cheapest by (next state, cost), whose first of
    each state is the winner; the winners by cost.  Then the beam prune,
    the trailing-silence update and the lattice rows (the pool's R
    cheapest).  Writes the five record planes into `out` ({pm, state,
    f_cost} [B, K], {lat_pm, lat_cost} [B, R]) and returns (new frontier,
    out); the new frontier is freshly allocated, never the old one.
    scratch is the kernel's (`SelectScratch`) and unused here."""
    tok_state, tok_cost, tok_tsil = frontier["state"], frontier["cost"], frontier["tsil"]
    B, K = tok_state.shape
    E = cbits.shape[1]
    dev = cbits.device
    K2 = min(E, K2)
    cb, order = torch.sort(cbits, dim=1, stable=True)
    order = order[:, :max(R, K2)]
    nsm_s, pm_s = torch.gather(nsm, 1, order), torch.gather(pm, 1, order)
    lat_cb, lat_pm = cb[:, :R], pm_s[:, :R]
    if E < R:
        lat_cb = torch.nn.functional.pad(lat_cb, (0, R - E), value=BIG_I32)
        lat_pm = torch.nn.functional.pad(lat_pm, (0, R - E), value=-1)
    # dedup by next state on the K2 cheapest: one stable sort on the int64
    # key (state << 32) | (cost key + 2^31), then the winners by cost
    c2, n2, p2 = cb[:, :K2], nsm_s[:, :K2], pm_s[:, :K2]
    _, o = torch.sort((n2.long() << 32) | (c2.long() + 2**31), dim=1, stable=True)
    sB_n, sB_c, sB_p = torch.gather(n2, 1, o), torch.gather(c2, 1, o), torch.gather(p2, 1, o)
    first = torch.ones_like(sB_n, dtype=torch.bool)
    first[:, 1:] = sB_n[:, 1:] != sB_n[:, :-1]
    alive = first & (sB_n != S) & (sB_c < BIG_I32)
    sC_k, o2 = torch.sort(torch.where(alive, sB_c, BIG_I32), dim=1, stable=True)
    sC_n, sC_p = torch.gather(sB_n, 1, o2), torch.gather(sB_p, 1, o2)
    if K2 < K:
        pad = K - K2
        sC_k = torch.nn.functional.pad(sC_k, (0, pad), value=BIG_I32)
        sC_n = torch.nn.functional.pad(sC_n, (0, pad), value=S)
        sC_p = torch.nn.functional.pad(sC_p, (0, pad), value=-1)
    kbits = sC_k[:, :K]
    new_cost = bits_cost(kbits)
    keep = (kbits < BIG_I32) & (kbits <= cost_bits(new_cost[:, :1] + beam))
    new_state = torch.where(keep, sC_n[:, :K], S)
    new_cost = torch.where(keep, new_cost, INF)
    pm_k = sC_p[:, :K]
    prev = (pm_k & PM_MASK) >> mbits  # logical: masked non-negative
    silk = (pm_k & PM_SIL_FLAG) != 0
    prev_ts = gather_rows_plain(tok_tsil.contiguous(), torch.where(keep, prev, 0))
    cand_ts = torch.where(
        silk, ((prev_ts & TSIL_MASK) + 1) | (prev_ts & SPEECH_BIT), SPEECH_BIT)
    new_tsil = torch.where(keep, cand_ts, 0)

    vb = valid[:, None]
    new_frontier = {
        "state": torch.where(vb, new_state, tok_state),
        "cost": torch.where(vb, new_cost, tok_cost),
        "tsil": torch.where(vb, new_tsil, tok_tsil),
    }
    slot = torch.arange(max(K, R), dtype=torch.int32, device=dev)
    ident_pm = torch.where(slot < K, PM_IDENT_FLAG | (slot << mbits), -1)[None, :]
    torch.where(vb, torch.where(keep, pm_k & PM_MASK, -1), ident_pm[:, :K], out=out["pm"])
    out["state"].copy_(new_frontier["state"])
    out["f_cost"].copy_(new_frontier["cost"])
    lat_cost = bits_cost(lat_cb)
    # worst-surviving-winner threshold: keeps every selected token's inbound
    # arc so the lattice stays connected
    wk = torch.where(torch.isfinite(new_cost), new_cost, -INF).amax(dim=1, keepdim=True)
    lkeep = (lat_cb < BIG_I32) & (lat_cost <= wk + lattice_beam)
    # identity lattice rows keep masked frames connected
    id_cost = tok_cost[:, :R]
    if R > K:
        id_cost = torch.cat([tok_cost, torch.full((B, R - K), INF, device=dev)], dim=1)
    torch.where(vb, torch.where(lkeep, lat_pm & PM_MASK, -1), ident_pm[:, :R],
                out=out["lat_pm"])
    torch.where(vb, torch.where(lkeep, lat_cost, INF), id_cost, out=out["lat_cost"])
    return new_frontier, out


# csrc/frame_step.cu: pass 2's buckets hold up to SELECT_SORT_CAP keys (the
# K winners, the R lattice rows) and its hash table up to SELECT_TABLE_CAP
# slots in the cluster's shared memory; past either, global scratch, with up
# to SELECT_MAX_CLUSTER CTAs a channel
SELECT_SORT_CAP = 8192
SELECT_TABLE_CAP = 20480
SELECT_MAX_CLUSTER = 8
_SELECT_MIN_SLOTS = 1024


def _rank_size(n: int) -> int:
    """The kernel's buffer for ranking n keys: whole tiles of 256."""
    return -(-n // 256) * 256


def select_table_slots(E: int, K2: int) -> int:
    """Hash slots of a channel in select_v4's pass 2: 5/4 of the K2
    cheapest candidates (at most 4/5 full), and at least _SELECT_MIN_SLOTS."""
    return max(_SELECT_MIN_SLOTS, (5 * min(K2, E) + 3) // 4)


def select_in_global(E: int, K: int, K2: int, R: int) -> bool:
    """Whether select_v4's pass 2 sorts and hashes in global scratch."""
    return (_rank_size(max(K, R)) > SELECT_SORT_CAP
            or select_table_slots(E, K2) > SELECT_TABLE_CAP)


class SelectScratch:
    """select_v4's device scratch, kept by its caller (a decoder holds one
    and frees it with itself; each captured chunk program holds its own,
    whose buffers its graph names, for as long as the graph lives).  Per
    (device, stream), since calls on one stream run in order: pass 1's
    per-channel best key and list count (pass 2 resets them to BIG and 0
    after reading them, so they are set only when allocated), its
    candidate lists [B * E] of int32 candidate numbers, and, where pass 2
    works in global scratch (`select_in_global`), its buckets (a row of
    sort keys per CTA) and its hash table (keys and values).  Each buffer
    grows to the largest call seen."""

    _DTYPES = {"best": torch.int32, "count": torch.int32, "list": torch.int32,
               "s": torch.int64, "tk": torch.int32, "tv": torch.int64}

    def __init__(self):
        self._bufs: dict = {}

    @staticmethod
    def need(B: int, E: int, K: int, K2: int, R: int) -> dict:
        """{buffer: elements} that one call needs (0: not used)."""
        glob = select_in_global(E, K, K2, R)
        cap = _rank_size(max(K, R))
        T = select_table_slots(E, K2) + SELECT_MAX_CLUSTER  # rounded up to C slots a CTA
        return {"best": B, "count": B, "list": B * E,
                "s": B * SELECT_MAX_CLUSTER * cap if glob else 0,
                "tk": B * T if glob else 0, "tv": B * T if glob else 0}

    @classmethod
    def nbytes(cls, B: int, E: int, K: int, K2: int, R: int) -> int:
        """Bytes of scratch one call needs."""
        return sum(n * cls._DTYPES[k].itemsize for k, n in cls.need(B, E, K, K2, R).items())

    def buffers(self, dev, stream, B: int, E: int, K: int, K2: int, R: int) -> dict:
        bufs = self._bufs.setdefault((dev, stream), {})
        need = self.need(B, E, K, K2, R)
        for name, n in need.items():
            have = bufs.get(name)
            if n and (have is None or have.numel() < n):
                dt = self._DTYPES[name]
                if name == "best":
                    bufs[name] = torch.full((n,), BIG_I32, dtype=dt, device=dev)
                elif name == "count":
                    bufs[name] = torch.zeros(n, dtype=dt, device=dev)
                else:
                    bufs[name] = torch.empty(n, dtype=dt, device=dev)
        return {k: bufs[k] if n else None for k, n in need.items()}


def select_v4(cbits, nsm, pm, frontier, valid, beam, lattice_beam, S, mbits, K2, R, out,
              scratch=None, stats=None):
    """`select_v4_plain` as the kernel select_v4 (two launches: a scan, then
    a cluster of CTAs per channel; no sort of the pool) on CUDA tensors; the
    plain version on CPU tensors.  The pool must be as `expand_v4` writes
    it: a candidate keyed below BIG has a next state below S; nsm and pm are
    defined where cbits < BIG, and neither version reads them elsewhere.  The record
    planes in `out` may be views of [T, B, K|R] buffers at frame t (rows
    contiguous); valid may be a column of a [B, T] mask.  scratch: a
    `SelectScratch` kept across calls (a fresh one per call when None).
    stats: None, or a [B, 3] int32 CUDA tensor that the kernel fills, for
    each unmasked channel, with pass 1's list length, the candidates in
    range of the beams and the winners (one per next state) before the cut
    at K.  `select_v4.launches` counts kernel calls."""
    tok_state, tok_cost, tok_tsil = frontier["state"], frontier["cost"], frontier["tsil"]
    _check_2d("frontier state", tok_state, torch.int32)
    B, K = tok_state.shape
    _check_2d("frontier cost", tok_cost, torch.float32, B, K)
    _check_2d("frontier tsil", tok_tsil, torch.int32, B, K)
    _check_2d("cbits", cbits, torch.int32, B)
    E = cbits.shape[1]
    _check_2d("nsm", nsm, torch.int32, B, E)
    _check_2d("pm", pm, torch.int32, B, E)
    for k, dt, n in (("pm", torch.int32, K), ("state", torch.int32, K),
                     ("f_cost", torch.float32, K), ("lat_pm", torch.int32, R),
                     ("lat_cost", torch.float32, R)):
        _check_2d(f"out[{k}]", out[k], dt, B, n)
    if not isinstance(valid, torch.Tensor) or valid.dtype != torch.bool or valid.shape != (B,):
        raise TypeError(f"valid must be a [B] bool tensor; got {getattr(valid, 'dtype', valid)} "
                        f"{tuple(getattr(valid, 'shape', ()))}")
    dev = _device_of(cbits, nsm, pm, tok_state, tok_cost, tok_tsil, valid,
                     *(out[k] for k in RECORD_PLANES))
    args = (cbits, nsm, pm, frontier, valid, beam, lattice_beam, S, mbits, K2, R, out)
    if dev.type == "cpu":
        return select_v4_plain(*args)
    dense = (cbits, nsm, pm, tok_state, tok_cost, tok_tsil, *(out[k] for k in RECORD_PLANES))
    if not all(x.is_contiguous() for x in dense):
        raise ValueError("select_v4 needs a contiguous pool, frontier and record rows")
    if B > 65535 or E >= 2**31 - 2**16 or K2 < 1 or R < 1:
        raise ValueError(f"select_v4 shape out of range: B={B} E={E} R={R} K2={K2}")
    new = {k: torch.empty_like(v) for k, v in frontier.items()}
    if B == 0 or E == 0:
        return new, out
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = (scratch if scratch is not None else SelectScratch()).buffers(
        dev, stream, B, E, K, K2, R)
    ptr = {k: None if v is None else v.data_ptr() for k, v in buf.items()}
    if stats is not None:
        _check_2d("stats", stats, torch.int32, B, 3)
        if stats.device != dev or not stats.is_contiguous():
            raise ValueError("stats must be a contiguous [B, 3] int32 tensor beside the pool")
    with torch.cuda.device(dev):
        err = _kernel("vt_select_v4")(
            cbits.data_ptr(), nsm.data_ptr(), pm.data_ptr(), E, tok_state.data_ptr(),
            tok_cost.data_ptr(), tok_tsil.data_ptr(), valid.data_ptr(), valid.stride(0),
            float(beam), float(lattice_beam), B, K, K2, R, S, mbits, ptr["best"],
            ptr["count"], ptr["list"], new["state"].data_ptr(), new["cost"].data_ptr(),
            new["tsil"].data_ptr(), *(out[k].data_ptr() for k in RECORD_PLANES), ptr["s"],
            ptr["tk"], ptr["tv"], None if stats is None else stats.data_ptr(), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    _launched("select_v4", err)
    if not capturing:
        select_v4.launches += 1
    return new, out


select_v4.launches = 0

# the v4 decoder's chunk programs (ops/viterbi.py): CUDA graphs captured and
# replays launched
GRAPH_COUNTS = {"captures": 0, "replays": 0}


def count_replay(T: int) -> None:
    """One replay of a captured T-frame chunk: T launches of each frame-step
    kernel."""
    expand_v4.launches += T
    select_v4.launches += T
    GRAPH_COUNTS["replays"] += 1


class StepOps(NamedTuple):
    """The pair the decoder's frame step calls (`BatchViterbi.step_ops`)."""

    expand: object
    select: object


KERNELS = StepOps(expand_v4, select_v4)
PLAIN = StepOps(expand_v4_plain, select_v4_plain)
