"""Holding one device's pitch features to another's (the card's to the
CPU's), for chip_smoke.py and the card tests.

The tracker's argmin over 71 lags may break a tie below rounding either
way on another device.  The forward costs do not depend on that choice,
so every frame's lag must agree unless the reference's two best costs lie
within TIE; the POV feature is compared wherever the lags agree; log pitch
enters the ring mean and the next delta, so normalized log pitch and delta
are compared up to the first tie broken the other way.
"""
from __future__ import annotations

import numpy as np
import torch

TIE = 1e-4
POV_ATOL = 1e-3    # 2((1.0001 - c)^0.15 - 1) has slope ~100 at c = 0.999
PITCH_ATOL = 1e-4  # normalized log pitch and delta
BASE_ATOL = 1e-3   # the MFCC dims


def stream(ex, audio: np.ndarray, chunk: int):
    """Stream [B, N] audio through extractor `ex` in `chunk`-sample pieces
    plus its pitch flush, recording each frame's lag and cost gap.  Returns
    per row (feats [T, dim], lags [T], gaps [T]) of the emitted frames, as
    numpy."""
    track = ex.pitch.track
    rec = []

    def frame_features(state, buf, start0, F, valid):
        st, feats, lags, gaps = track(state, buf, start0, F, valid, gaps=True)
        rec.append((lags, gaps))
        return st, feats

    ex.pitch.frame_features = frame_features
    try:
        B = audio.shape[0]
        padded = np.concatenate([audio, np.zeros((B, ex.flush_pad_samples), np.float32)], 1)
        st = ex.init_stream_state(B, chunk)
        out = [([], [], []) for _ in range(B)]
        for pos in range(0, padded.shape[1], chunk):
            c = padded[:, pos:pos + chunk]
            n = c.shape[1]
            c = np.pad(c, ((0, 0), (0, chunk - n)))
            st, f, v = ex.extract_chunk(
                st, torch.from_numpy(c).to(ex.device),
                torch.full((B,), n, dtype=torch.int32, device=ex.device))
            lags, gaps = rec[-1]
            f, v, lags, gaps = f.cpu().numpy(), v.cpu().numpy(), lags.cpu().numpy(), \
                gaps.cpu().numpy()
            for b in range(B):
                for lst, x in zip(out[b], (f[b], lags[b], gaps[b])):
                    lst.append(x[v[b]])
    finally:
        del ex.pitch.frame_features
    return [tuple(np.concatenate(x) for x in row) for row in out]


def compare(got, want) -> dict:
    """`stream` outputs of a device under test (`got`) and a reference
    (`want`), row by row.  Raises AssertionError on a violation; returns
    the largest differences and the frame counts."""
    stats = dict(frames=0, ties_broken_otherwise=0, pov_err=0.0, pitch_err=0.0,
                 pitch_frames=0, base_err=0.0)
    base = got[0][0].shape[1] - 3
    for (gf, gl, _), (wf, wl, wg) in zip(got, want):
        if gf.shape != wf.shape:
            raise AssertionError(f"frame counts differ: {gf.shape} vs {wf.shape}")
        differ = gl != wl
        if np.any(wg[differ] >= TIE):
            raise AssertionError(f"lags differ off a tie at frames {np.flatnonzero(differ)}")
        first = int(np.argmax(differ)) if differ.any() else len(gl)
        same = ~differ
        stats["frames"] += len(gl)
        stats["ties_broken_otherwise"] += int(differ.sum())
        stats["pitch_frames"] += first
        if len(gl):
            stats["base_err"] = max(stats["base_err"],
                                    float(np.abs(gf[:, :base] - wf[:, :base]).max()))
        if same.any():
            stats["pov_err"] = max(stats["pov_err"],
                                   float(np.abs(gf[same, base] - wf[same, base]).max()))
        if first:
            stats["pitch_err"] = max(stats["pitch_err"], float(
                np.abs(gf[:first, base + 1:] - wf[:first, base + 1:]).max()))
    if not (stats["pov_err"] <= POV_ATOL and stats["pitch_err"] <= PITCH_ATOL
            and stats["base_err"] <= BASE_ATOL):
        raise AssertionError(f"pitch features disagree: {stats}")
    return stats
