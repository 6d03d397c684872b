"""Per-channel table gather: out[b, n] = table[b, idx[b, n]].

`gather_rows` launches the hand-written Hopper kernel in csrc/gather.cu on
CUDA tensors; it replaces the JAX package's only Pallas kernel,
`vosk_tpu/ops/gather.py:_pallas_gather` (see the note at the top of the
CUDA source for what bounds it and what its design does about that).
`gather_rows_plain` is the plain PyTorch version of the same function: the
wrapper uses it for CPU tensors, and tests compare the kernel with it.  The
decoder's v3 frame step (ops/viterbi_v3.py) calls it at the source's four
v3 sites: ll[b, pdf], tsil[b, prev], and per eps round state[b, src] and
tsil[b, prev], 2 + 2 * eps_iters launches a decoded frame, and so does its
sharded mode (`decode_chunk_sharded`, the source's :669 and :716 under
`_frame_step_sharded`).  The v4 step does not: its two lookups live inside
the frame-step kernels (ops/frame_step.py), the sharded v4 step's ll lookup
in `expand_v4` over a stripe of the frontier.
"""
from __future__ import annotations

import ctypes

import torch

from . import _kernels

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# how the kernel reads the table row: in place, staged in each block by a
# bulk copy, or multicast over a cluster of the channel's tiles
GATHER_STAGES = {"in_place": 0, "staged": 1, "multicast": 2}


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if not (isinstance(table, torch.Tensor) and isinstance(idx, torch.Tensor)):
        raise TypeError("gather_rows takes torch tensors")
    if table.dim() != 2 or idx.dim() != 2 or table.shape[0] != idx.shape[0]:
        raise ValueError(
            f"gather_rows needs table [B, P] and idx [B, N]; got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}"
        )
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if table.element_size() != 4 or table.is_complex():
        raise TypeError(f"gather_rows copies 4-byte elements; got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows needs int32 indices; got {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous tensors")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: torch.gather with an index outside [0, P)
    giving 0, as the JAX versions do."""
    _check(table, idx)
    P = table.shape[1]
    inb = (idx >= 0) & (idx < P)
    if P == 0:
        return torch.zeros(idx.shape, dtype=table.dtype, device=table.device)
    got = torch.gather(table, 1, torch.where(inb, idx, 0).long())
    return torch.where(inb, got, torch.zeros((), dtype=table.dtype,
                                             device=table.device))


def gather_rows(table: torch.Tensor, idx: torch.Tensor, stage=None) -> torch.Tensor:
    """out[b, n] = table[b, idx[b, n]] for a 4-byte table and int32 indices;
    0 where an index is outside [0, P).

    CUDA tensors go to the kernel, which raises if it cannot build or
    launch; CPU tensors go to `gather_rows_plain`.  stage: None lets the
    kernel choose how it reads the table row by shape; a key of
    GATHER_STAGES forces one (for measurement; a row the bulk copy cannot
    take, or longer than shared memory holds, is read in place all the
    same).  `gather_rows.launches` counts kernel launches."""
    _check(table, idx)
    if stage is not None and stage not in GATHER_STAGES:
        raise ValueError(f"stage must be None or one of {list(GATHER_STAGES)}; got {stage!r}")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {table.device}")
    B, P = table.shape
    N = idx.shape[1]
    if B > 65535 or B * max(P, N) >= 2**31:
        raise ValueError(f"gather_rows shape out of range: B={B} P={P} N={N}")
    # out at idx's offset from a 16-byte boundary, so that both move as
    # 16-byte vectors (a view into one more vector's room when idx is a
    # view off that boundary)
    shift = idx.data_ptr() % 16 // 4
    out = torch.empty(B * N + shift, dtype=table.dtype, device=table.device)[shift:].view(B, N)
    if B == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = _kernels.function("vt_gather_rows", _ARGTYPES)(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, P, N,
            -1 if stage is None else GATHER_STAGES[stage], stream
        )
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {err}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
