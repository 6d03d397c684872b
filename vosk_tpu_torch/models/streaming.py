"""Generic streaming wrapper for acoustic models, in PyTorch.

Port of `vosk_tpu/models/streaming.py` (`init_stream_state`,
`_process_chunk_impl`, `_flush_impl` as `flush`).  Any module exposing
`forward(window [B, W, D], ivector [B, I] or None) -> [B, ceil(W/ss), P]`
with known left/right context and subsampling gets chunked streaming with
carried feature history, masked per-channel advance, and end-of-stream
flush.  The optional i-vector is passed through to every forward.  State
tensors live on the model's device.
"""
from __future__ import annotations

import torch


class StreamingAm:
    """Mixin: the subclass provides `feat_dim`, `subsample`, `left_context`,
    `right_context`, `device` and `forward(window, ivector=None)`."""

    feat_dim: int
    subsample: int
    left_context: int
    right_context: int

    @property
    def _left_pad(self) -> int:
        ss = self.subsample
        return ((self.left_context + ss - 1) // ss) * ss

    def init_stream_state(self, batch: int, chunk_frames: int) -> dict:
        H = self._left_pad + self.right_context + chunk_frames + self.subsample
        z = dict(device=self.device)
        return {
            "hist": torch.zeros((batch, H, self.feat_dim), dtype=torch.float32, **z),
            "hist_len": torch.zeros((batch,), dtype=torch.int32, **z),
            "feats_seen": torch.zeros((batch,), dtype=torch.int32, **z),
            "out_emitted": torch.zeros((batch,), dtype=torch.int32, **z),
        }

    def stream_max_out(self, chunk_frames: int) -> int:
        return chunk_frames // self.subsample + 1

    def _process_chunk_impl(self, state, feats, valid, ivector=None):
        B, F, D = feats.shape
        hist, hist_len = state["hist"], state["hist_len"]
        H = hist.shape[1]
        O = self.stream_max_out(F)
        ss, R = self.subsample, self.right_context
        Lp = self._left_pad
        dev = feats.device

        def take_rows(x, idx):  # x [B, L, D], idx [B, M] -> [B, M, D]
            return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[2]))

        n_new = valid.sum(dim=1).to(torch.int32)

        col = torch.arange(H, dtype=torch.int32, device=dev)[None, :]
        overflow = torch.clamp(hist_len + n_new - H, min=0)
        src = torch.clamp(col + overflow[:, None], 0, H - 1)
        hist = take_rows(hist, src)
        hist_len2 = hist_len - overflow
        fsrc = torch.clamp(col - hist_len2[:, None], 0, F - 1)
        newf = take_rows(feats.to(torch.float32), fsrc)
        write = (col >= hist_len2[:, None]) & (col < (hist_len2 + n_new)[:, None])
        hist = torch.where(write[:, :, None], newf, hist)
        hist_len3 = hist_len2 + n_new

        feats_seen = state["feats_seen"] + n_new
        out_emitted = state["out_emitted"]

        total_out_ready = torch.clamp(
            torch.div(feats_seen - R - 1, ss, rounding_mode="floor") + 1, min=0
        )
        n_out = torch.clamp(total_out_ready - out_emitted, 0, O)

        W = (O - 1) * ss + Lp + R + 1
        hist_base = feats_seen - hist_len3
        off = out_emitted * ss - Lp - hist_base
        wcol = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        widx = torch.clamp(wcol + off[:, None], 0, H - 1)
        window = take_rows(hist, widx)

        out = self.forward(window, ivector)
        out = out[:, Lp // ss : Lp // ss + O]

        out_valid = torch.arange(O, dtype=torch.int32, device=dev)[None, :] < n_out[:, None]
        out = torch.where(out_valid[:, :, None], out, 0.0)

        return (
            {
                "hist": hist,
                "hist_len": hist_len3,
                "feats_seen": feats_seen,
                "out_emitted": out_emitted + n_out,
            },
            out,
            out_valid,
        )

    process_chunk = _process_chunk_impl

    def flush_inputs(self, state, mask=None):
        """Edge-copy right padding that flushes the right context: the
        (pad_feats [B, R+ss, D], pad_valid [B, R+ss]) chunk `_flush_impl`
        feeds, restricted to the channels in `mask` [B] bool when given."""
        ss, R = self.subsample, self.right_context
        hist, hist_len = state["hist"], state["hist_len"]
        B, H, D = hist.shape
        feats_seen = state["feats_seen"]
        total_out = torch.div(feats_seen + ss - 1, ss, rounding_mode="floor")
        need = torch.clamp((total_out - 1) * ss + R + 1 - feats_seen, min=0)
        if mask is not None:
            need = torch.where(mask, need, 0)
        P = R + ss
        li = torch.clamp(hist_len - 1, 0, H - 1).long()
        last = hist[torch.arange(B, device=hist.device), li]  # [B, D]
        pad_feats = last[:, None, :].expand(B, P, D)
        pad_valid = torch.arange(P, device=hist.device)[None, :] < need[:, None]
        return pad_feats, pad_valid

    def _flush_impl(self, state, ivector=None):
        pad_feats, pad_valid = self.flush_inputs(state)
        return self._process_chunk_impl(state, pad_feats, pad_valid, ivector)

    # end-of-stream flush of every channel (the streaming recognizer's
    # B = 1 state), under the source's name
    flush = _flush_impl
