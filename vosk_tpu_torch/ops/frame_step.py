"""The v4 frame step's two kernels: expand, and the tail of select.

Per frame the decoder (ops/viterbi.py) runs
  * `expand_v4`: tokens -> scored candidates (cbits, nsm, pm), each
    [B, K*M]: the packed arc-row read, the acoustic lookup ll[b, pdf] and
    the order-preserving cost keys in one pass (source:
    `vosk_tpu/ops/viterbi.py` `_unpack_rows_v4` + `_expand_v4`, :833-894);
  * three stable sorts, kept as torch ops (the source's `lax.sort` calls);
  * `select_tail_v4`: the beam prune, the trailing-silence lookup
    tsil[b, prev], the new frontier and the five record planes in one pass
    (source: `_select_v4` after its sorts, :1094-1154).
Together they replace the JAX package's Pallas kernel `_pallas_gather`
(vosk_tpu/ops/gather.py:33) at its two v4 call sites (:879 and :1105), and
the torch ops that made its indices and consumed its output.

Each wrapper launches its hand-written Hopper kernel (csrc/frame_step.cu,
built with the other csrc/ sources into one library by ops/_kernels.py) on
CUDA tensors, and runs its plain PyTorch version on CPU tensors;
`<wrapper>.launches` counts kernel launches.  `KERNELS` and `PLAIN` bundle
the pairs for the decoder's `step_ops` hook.

Bit parity with the JAX decoder: XLA on the CPU contracts the source's
`(tok_cost + w) - scale * ac` into one fused multiply-add, so the cost is
rounded once after the f32 sum.  The kernel computes that FMA; the plain
version computes the difference exactly in float64, rounds it to odd and
casts once (53 >= 2 * 24 + 2 bits, so the cast rounds correctly).
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


def expand_v4_plain(em_pack, tok_state, tok_cost, ll, acoustic_scale, S, M, mbits):
    """Tokens -> scored candidates (cbits, nsm, pm), each [B, K*M] int32.

    em_pack [S+1, 2M] int32 packed16 rows (f16(w) << 16 | sil << 14 | pdf,
    then next state); tok_state, tok_cost [B, K]; ll [B, P] f32, any
    strides.  Candidate e = k*M + m."""
    B, K = tok_state.shape
    E = K * M
    rows = em_pack[tok_state.long()]  # [B, K, 2M]
    p1 = rows[:, :, :M].reshape(B, E)
    nsf = rows[:, :, M:].reshape(B, E)
    # f16 weight bits = the top half-word of p1, brought into int16 range by
    # value (no saturating narrowing cast), then bit-viewed
    h = (p1 >> 16) & 0xFFFF
    w = torch.where(h >= 0x8000, h - 0x10000, h).to(torch.int16)
    w = w.view(torch.float16).to(torch.float32)
    sil = (p1 >> 14) & 1
    pdf = p1 & ((1 << 14) - 1)
    ac = gather_rows_plain(ll.contiguous(), pdf)
    cost = sub_scaled(tok_cost.repeat_interleave(M, dim=1) + w, acoustic_scale, ac)
    finite = torch.isfinite(w)
    cbits = torch.where(finite, cost_bits(cost), BIG_I32)
    nsm = torch.where(finite, nsf & NS_MASK, S)
    e = torch.arange(E, dtype=torch.int32, device=p1.device)
    prevm = ((e // M) << mbits) | (e % M)
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
    "vt_expand_v4": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "vt_select_tail_v4": [_P, _P, _P, _P, _I, _P, _LL, _P, _LL, _P, _P, _P, _P, _LL,
                          _F, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _kernel(name: str):
    """The C entry point `name` of the shared kernel library, typed."""
    return _kernels.function(name, _SIGNATURES[name])


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# how the expand kernel reads the ll row: staged by a bulk copy, or in place
EXPAND_STAGES = {"bulk": 0, "in_place": 1}


def expand_v4(em_pack, tok_state, tok_cost, ll, acoustic_scale, S, M, mbits, stage=None):
    """`expand_v4_plain` as one kernel launch on CUDA tensors (the plain
    version on CPU tensors).  ll may be a row-strided view ([B, T, P]
    chunk at frame t).  stage: None lets the kernel choose how it reads
    the ll row; a key of EXPAND_STAGES forces one (for measurement).
    `expand_v4.launches` counts kernel launches."""
    _check_2d("tok_state", tok_state, torch.int32)
    B, K = tok_state.shape
    _check_2d("em_pack", em_pack, torch.int32, cols=2 * M)
    _check_2d("tok_cost", tok_cost, torch.float32, B, K)
    _check_2d("ll", ll, torch.float32, B)
    dev = _device_of(em_pack, tok_state, tok_cost, ll)
    if dev.type == "cpu":
        return expand_v4_plain(em_pack, tok_state, tok_cost, ll, acoustic_scale, S, M, mbits)
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
            ll.stride(0), ll.shape[1], float(acoustic_scale), B, K, S, M, mbits,
            *(o.data_ptr() for o in out), -1 if stage is None else EXPAND_STAGES[stage],
            stream)
    _launched("expand_v4", err)
    expand_v4.launches += 1
    return tuple(out)


expand_v4.launches = 0

# ---------------------------------------------------------------- select


def select_tail_v4_plain(sC_k, o2, sB_n, sB_p, lat_cb, lat_pm, frontier, valid,
                         beam, lattice_beam, S, mbits, out):
    """The tail of the v4 selection, after the re-rank sort.

    sC_k [B, K2] int32: the winners' cost keys, sorted ascending; o2 [B, K2]
    int64: the sort's order into sB_n / sB_p [B, K2] (the deduped next
    states and pm words); lat_cb / lat_pm [B, R]: the cost-ordered prefix of
    the candidate pool; frontier {state, cost, tsil} [B, K]; valid [B] bool.
    Writes the five record planes into `out` ({pm, state, f_cost} [B, K],
    {lat_pm, lat_cost} [B, R]) and returns (new frontier, out); the new
    frontier is freshly allocated, never the old one."""
    tok_state, tok_cost, tok_tsil = frontier["state"], frontier["cost"], frontier["tsil"]
    B, K = tok_state.shape
    K2 = sC_k.shape[1]
    dev = sC_k.device
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
    R = lat_cb.shape[1]
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


def select_tail_v4(sC_k, o2, sB_n, sB_p, lat_cb, lat_pm, frontier, valid,
                   beam, lattice_beam, S, mbits, out):
    """`select_tail_v4_plain` as one kernel launch on CUDA tensors (the
    plain version on CPU tensors).  The record planes in `out` may be views
    of [T, B, K|R] buffers at frame t (rows contiguous); valid may be a
    column of a [B, T] mask.  `select_tail_v4.launches` counts launches."""
    tok_state, tok_cost, tok_tsil = frontier["state"], frontier["cost"], frontier["tsil"]
    _check_2d("frontier state", tok_state, torch.int32)
    B, K = tok_state.shape
    _check_2d("frontier cost", tok_cost, torch.float32, B, K)
    _check_2d("frontier tsil", tok_tsil, torch.int32, B, K)
    _check_2d("sC_k", sC_k, torch.int32, B)
    K2 = sC_k.shape[1]
    _check_2d("o2", o2, torch.int64, B, K2)
    _check_2d("sB_n", sB_n, torch.int32, B, K2)
    _check_2d("sB_p", sB_p, torch.int32, B, K2)
    _check_2d("lat_cb", lat_cb, torch.int32, B)
    R = lat_cb.shape[1]
    _check_2d("lat_pm", lat_pm, torch.int32, B, R)
    for k, dt, n in (("pm", torch.int32, K), ("state", torch.int32, K),
                     ("f_cost", torch.float32, K), ("lat_pm", torch.int32, R),
                     ("lat_cost", torch.float32, R)):
        _check_2d(f"out[{k}]", out[k], dt, B, n)
    if valid.dtype != torch.bool or valid.shape != (B,):
        raise TypeError(f"valid must be a [B] bool tensor; got {valid.dtype} "
                        f"{tuple(valid.shape)}")
    dev = _device_of(tok_state, tok_cost, tok_tsil, sC_k, o2, sB_n, sB_p, lat_cb,
                     lat_pm, valid, *(out[k] for k in RECORD_PLANES))
    args = (sC_k, o2, sB_n, sB_p, lat_cb, lat_pm, frontier, valid, beam,
            lattice_beam, S, mbits, out)
    if dev.type == "cpu":
        return select_tail_v4_plain(*args)
    dense = (tok_state, tok_cost, tok_tsil, sC_k, o2, sB_n, sB_p,
             *(out[k] for k in RECORD_PLANES))
    if not all(x.is_contiguous() for x in dense):
        raise ValueError("select_tail_v4 needs contiguous frontier, sort outputs and "
                         "record rows")
    if B > 65535 or max(K, R) >= 2**31 - 256:
        raise ValueError(f"select_tail_v4 shape out of range: B={B} K={K} R={R}")
    new = {k: torch.empty_like(v) for k, v in frontier.items()}
    if B == 0 or max(K, R) == 0:
        return new, out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("vt_select_tail_v4")(
            sC_k.data_ptr(), o2.data_ptr(), sB_n.data_ptr(), sB_p.data_ptr(), K2,
            lat_cb.data_ptr(), lat_cb.stride(0), lat_pm.data_ptr(), lat_pm.stride(0),
            tok_state.data_ptr(), tok_cost.data_ptr(), tok_tsil.data_ptr(),
            valid.data_ptr(), valid.stride(0),
            float(beam), float(lattice_beam), B, K, R, S, mbits,
            new["state"].data_ptr(), new["cost"].data_ptr(), new["tsil"].data_ptr(),
            *(out[k].data_ptr() for k in RECORD_PLANES), stream)
    _launched("select_tail_v4", err)
    select_tail_v4.launches += 1
    return new, out


select_tail_v4.launches = 0


class StepOps(NamedTuple):
    """The pair the decoder's frame step calls (`BatchViterbi.step_ops`)."""

    expand: object
    select_tail: object


KERNELS = StepOps(expand_v4, select_tail_v4)
PLAIN = StepOps(expand_v4_plain, select_tail_v4_plain)
