"""Pitch features (NCCF + Viterbi lag tracking + POV), Kaldi-style, in
PyTorch.

Port of `vosk_tpu/ops/pitch.py`.  The reference enables Kaldi's online
pitch when a model ships conf/pitch.conf (src/model.cc:265-276); the
algorithm is Ghahremani et al. 2014, as in Kaldi feat/pitch-functions.cc:
decimate to `resample_rate`, NCCF per 10 ms frame over the integer lag
grid, Viterbi smoothing over lags with a log-lag transition penalty, and
per-frame [POV feature, POV-weighted mean-subtracted log pitch, delta log
pitch].  `PitchOptions` and the numpy tables of `StreamingPitch.__init__`
are copies of the source's (tests/test_torch_copies.py holds them to it).

The source writes the streaming tracker as one `lax.scan` over frames.  On
the card each op of such a loop is a launch, so the port keeps in the
per-frame loop only what is sequential: the running frame-energy sum (the
ballast's mean square, summed in frame order so any chunking gives the
same bits) and the Viterbi step `min(fwd + trans) - obs`, its
renormalisation and argmin.  The NCCF over all lags is one strided view
(`unfold`), and POV, log pitch, the POV-weighted ring mean and the delta
are computed for all of a chunk's frames at once after the loop, from
each frame's count of valid frames before it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PitchOptions:
    sample_rate: float = 16000.0
    resample_rate: float = 4000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    penalty_factor: float = 0.1
    nccf_ballast: float = 7000.0
    pov_scale: float = 2.0
    delta_window: int = 2
    mean_window: int = 151  # POV-weighted moving mean of log pitch


def _nccf(sig: torch.Tensor, window: int, shift: int, max_lag: int):
    """sig: [N] at the resampled rate.  Returns [T, max_lag+1] NCCF (lag 0
    column unused), frame energies [T] and the mean square (a 0-d
    tensor)."""
    n = sig.shape[0]
    T = max(1 + (n - window - max_lag) // shift, 1)
    dev = sig.device
    idx = (torch.arange(T, device=dev) * shift)[:, None] + torch.arange(
        window + max_lag, device=dev)[None, :]
    frames = sig[idx.clamp(0, n - 1)]  # [T, window+max_lag]
    x0 = frames[:, :window]
    x0c = x0 - x0.mean(dim=1, keepdim=True)
    e0 = (x0c * x0c).sum(dim=1)
    xl = frames.unfold(1, window, 1)  # [T, max_lag+1, window], one view
    xlc = xl - xl.mean(dim=-1, keepdim=True)
    nums = (x0c[:, None, :] * xlc).sum(dim=-1)
    els = (xlc * xlc).sum(dim=-1)
    mean_sq = e0.mean() / window + 1e-12
    den = torch.sqrt(e0[:, None] * els + 1e-10)
    return nums / den, e0, mean_sq


def compute_pitch_features(wave, opts: PitchOptions = PitchOptions(), device="cuda"):
    """wave: [N] float at opts.sample_rate.  Returns numpy (feats [T, 3] =
    (pov_feature, normalized_log_pitch, delta_log_pitch), pitch_hz [T],
    pov [T]).  The offline tracker: NCCF and the forward Viterbi on
    `device`, the backtrack and the smoothing on the host, as in the
    source."""
    from .resample import resample_offline

    wave = np.asarray(wave, np.float32)
    rr = opts.resample_rate
    if abs(rr - opts.sample_rate) > 1e-6:
        sig = resample_offline(wave, opts.sample_rate, rr)
    else:
        sig = wave
    sig = torch.as_tensor(sig / max(np.abs(sig).max(), 1e-6), device=device)

    shift = int(rr * opts.frame_shift_ms / 1000.0)
    window = int(rr * opts.frame_length_ms / 1000.0)
    min_lag = max(int(rr / opts.max_f0), 2)
    max_lag = int(rr / opts.min_f0)
    nccf, e0, mean_sq = _nccf(sig, window, shift, max_lag)
    nccf = nccf.cpu().numpy()[:, min_lag:]  # [T, L]
    T, L = nccf.shape
    lags_s = (np.arange(min_lag, max_lag + 1)) / rr  # lag in seconds

    # ballast flavor for pitch tracking (de-emphasizes silence); the raw
    # nccf above (no ballast) is the POV statistic
    ballast = opts.nccf_ballast * float(mean_sq)
    e0n = e0.cpu().numpy()
    scale = np.sqrt(e0n / (e0n + ballast * window))[:, None]
    nccf_pitch = nccf * scale
    # short-lag preference against subharmonic (octave-down) picks
    lag_bias = 1.0 - 0.02 * (np.log(lags_s) - np.log(lags_s[0]))
    nccf_pitch = nccf_pitch * lag_bias[None, :]

    # Viterbi over lags: local cost = -nccf_pitch, transition cost =
    # penalty * (log lag ratio)^2 (pitch-functions.cc ComputeLocalCost)
    loglags = np.log(lags_s)
    trans = opts.penalty_factor * (loglags[:, None] - loglags[None, :]) ** 2

    if T > 1:
        obs = torch.as_tensor(nccf_pitch.astype(np.float32), device=device)
        tr = torch.as_tensor(trans.astype(np.float32), device=device)
        car, costs, bps = -obs[0], [], []
        for t in range(1, T):
            best, bp = torch.min(car[:, None] + tr, dim=0)
            car = best - obs[t]
            costs.append(car)
            bps.append(bp)
        costs = torch.stack(costs).cpu().numpy()
        bps = torch.stack(bps).cpu().numpy()
        path = np.zeros(T, np.int64)
        path[-1] = int(np.argmin(costs[-1]))
        for t in range(T - 2, -1, -1):
            path[t] = bps[t][path[t + 1]]
    else:
        path = np.array([int(np.argmax(nccf_pitch[0]))])

    pitch_hz = 1.0 / lags_s[path]
    nccf_at = nccf[np.arange(T), path]

    # POV feature: the paper's monotone transform of the (ballast-free)
    # NCCF at the chosen lag
    c = np.clip(nccf_at, -1.0, 1.0)
    pov_raw = np.abs(c)
    pov_feature = opts.pov_scale * (np.power(1.0001 - c, 0.15) - 1.0)
    pov = np.clip(pov_raw, 0.0, 1.0)

    # POV-weighted moving-mean subtraction of log pitch
    logp = np.log(pitch_hz)
    half = opts.mean_window // 2
    norm_logp = np.empty(T, np.float32)
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        w = pov[lo:hi] + 1e-4
        norm_logp[t] = logp[t] - float(np.sum(w * logp[lo:hi]) / np.sum(w))

    # delta of log pitch (standard 2-sided delta window)
    dw = opts.delta_window
    k = np.arange(-dw, dw + 1, dtype=np.float32)
    denom = float(np.sum(k * k))
    pad = np.pad(logp, (dw, dw), mode="edge")
    delta = np.convolve(pad, -k / denom, mode="valid").astype(np.float32)

    feats = np.stack([pov_feature, norm_logp, delta], axis=1).astype(np.float32)
    return feats, pitch_hz.astype(np.float32), pov.astype(np.float32)


class StreamingPitch:
    """Chunk-invariant streaming pitch inside the feature pipeline (the
    source's `StreamingPitch`): FIR decimation to `resample_rate`, NCCF
    over the lag grid, online Viterbi lag tracking carried across chunks
    (each frame emits the filtering argmin), a POV-weighted mean of log
    pitch over a backward ring of `mean_window` frames, and delta(log
    pitch) as the one-frame backward difference.  Frame emission is
    delayed by `la16` input samples (pitch lookahead + FIR halfwidth) so
    every emitted frame has its full NCCF window.  The state and the tables
    live on `device`."""

    NCCF_BLOCK = 256  # frames per NCCF block (bounds the [B, F, L, ws4] view's copies)

    def __init__(self, opts: PitchOptions = PitchOptions(), device="cuda"):
        self.opts = opts
        self.device = torch.device(device)
        rr, sr = opts.resample_rate, opts.sample_rate
        R = int(round(sr / rr))
        if abs(R * rr - sr) > 1e-3:
            raise ValueError(
                f"pitch resample rate {rr} must divide the sample rate {sr}")
        self.R = R
        self.sh16 = int(sr * opts.frame_shift_ms / 1000.0)
        self.ws16 = int(sr * opts.frame_length_ms / 1000.0)
        if self.sh16 % R:
            raise ValueError("frame shift must be a multiple of the "
                             "pitch decimation factor")
        self.sh4 = self.sh16 // R
        self.ws4 = self.ws16 // R
        self.min_lag = max(int(rr / opts.max_f0), 2)
        self.max_lag = int(rr / opts.min_f0)
        self.L = self.max_lag - self.min_lag + 1
        self.MW = opts.mean_window

        # FIR decimation taps (Hann-windowed sinc, Kaldi FilterFunc shape),
        # normalized to unit DC gain
        cutoff = 0.99 * 0.5 * rr
        hw_s = 10.0 / (2.0 * cutoff)  # 10-zero windowed sinc
        W16 = int(np.ceil(hw_s * sr))
        t = np.arange(-W16, W16 + 1) / sr
        win = np.where(np.abs(t) < hw_s,
                       0.5 * (1.0 + np.cos(np.pi / hw_s * t)), 0.0)
        x = 2.0 * cutoff * t
        sinc = np.where(x == 0.0, 1.0,
                        np.sin(np.pi * x) / np.where(x == 0.0, 1.0, np.pi * x))
        h = (win * sinc).astype(np.float32)
        self.fir = h / h.sum()
        self.W16 = W16
        # input-sample lookahead an emitted frame needs beyond its MFCC
        # window: the NCCF lag tail plus the FIR halfwidth
        self.la16 = R * self.max_lag + W16

        lags_s = np.arange(self.min_lag, self.max_lag + 1) / rr
        self.lags_s = lags_s.astype(np.float32)
        self.neg_log_lags = (-np.log(lags_s)).astype(np.float32)  # log f0
        loglags = np.log(lags_s)
        self.trans = (opts.penalty_factor
                      * (loglags[:, None] - loglags[None, :]) ** 2
                      ).astype(np.float32)
        self.lag_bias = (1.0 - 0.02 * (loglags - loglags[0])).astype(np.float32)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        self._fir, self._trans = dev(self.fir), dev(self.trans)
        self._lag_bias, self._neg_log_lags = dev(self.lag_bias), dev(self.neg_log_lags)

    # -------------------------------------------------------------- state

    def init_state(self, batch: int) -> dict:
        L, MW = self.L, self.MW

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return {
            "fwd": z(batch, L),
            "ring_logp": z(batch, MW),
            "ring_w": z(batch, MW),
            "ring_pos": z(batch, dtype=torch.int32),
            "e_sum": z(batch),
            "n_frames": z(batch, dtype=torch.int32),
            "prev_logp": z(batch),
        }

    # ------------------------------------------------------------- compute

    def _nccf_frames(self, buf, start0, F):
        """NCCF of this chunk's F frames: ([B, F, L] ballast-free NCCF over
        the lag grid, [B, F] frame energies)."""
        R, ws4, sh4, max_lag, W16 = self.R, self.ws4, self.sh4, self.max_lag, self.W16
        B, Wb = buf.shape
        dev = buf.device
        Lr = (F - 1) * sh4 + ws4 + max_lag  # decimated region length

        # FIR decimation of the region (gather + product, edge-clipped:
        # interior frames always have real margin because the pipeline
        # retains W16 extra tail samples)
        taps = self._fir.shape[0]
        qi = torch.arange(Lr, dtype=torch.int32, device=dev) * R
        ti = torch.arange(taps, dtype=torch.int32, device=dev) - W16
        idx = (start0[:, None, None] + qi[None, :, None] + ti[None, None, :]).clamp(0, Wb - 1)
        x16 = torch.gather(buf, 1, idx.reshape(B, -1).long()).reshape(B, Lr, taps)
        # a product and a row sum, not a matmul: a BLAS product rounds a row
        # by its position in the block, and the chunking moves the rows
        sig4 = (x16 * self._fir).sum(dim=-1)  # [B, Lr]

        frames = sig4.unfold(1, ws4 + max_lag, sh4)  # [B, F, ws4+max_lag]
        x0 = frames[..., :ws4]
        x0c = x0 - x0.mean(dim=-1, keepdim=True)
        e0 = (x0c * x0c).sum(dim=-1)  # [B, F]
        nums, els = [], []
        for f0 in range(0, F, self.NCCF_BLOCK):
            f1 = min(f0 + self.NCCF_BLOCK, F)
            # every lag's window as one strided view [B, f, L, ws4]
            xl = frames[:, f0:f1, self.min_lag:].unfold(2, ws4, 1)
            xlc = xl - xl.mean(dim=-1, keepdim=True)
            nums.append((x0c[:, f0:f1, None, :] * xlc).sum(dim=-1))
            els.append((xlc * xlc).sum(dim=-1))
        nums, els = torch.cat(nums, dim=1), torch.cat(els, dim=1)
        return nums / torch.sqrt(e0[..., None] * els + 1e-10), e0

    def frame_features(self, state, buf, start0, F, valid):
        """Pitch features for this chunk's frames.

        buf: [B, W] raw-input working buffer (the MFCC pipeline's); start0:
        [B] buffer-local input-sample index of frame 0's window start; F:
        frame budget; valid: [B, F] frame mask.  Returns (state', [B, F, 3]).
        A frame that is not valid leaves the state as it was, as in the
        source's scan.
        """
        state2, feats, _ = self.track(state, buf, start0, F, valid)
        return state2, feats

    def track(self, state, buf, start0, F, valid, gaps=False):
        """`frame_features`, with the lag-grid index each frame chose [B, F]
        as a third output and, with `gaps`, the distance between each
        frame's two best Viterbi costs [B, F] as a fourth (a tie below
        rounding may break either way on another device)."""
        o = self.opts
        ws4, MW = self.ws4, self.MW
        nccf, e0 = self._nccf_frames(buf, start0, F)
        v = valid.to(torch.bool)

        # the ballast's running mean square: the energy sum in frame order,
        # f32 as the source's scan sums it
        e_v = torch.where(v, e0, 0.0)
        e_sum, sums = state["e_sum"], []
        for f in range(F):
            e_sum = e_sum + e_v[:, f]
            sums.append(e_sum)
        vi = v.to(torch.int32)
        k_incl = torch.cumsum(vi, dim=1, dtype=torch.int32)  # valid frames up to f
        k_excl = k_incl - vi                                  # valid frames before f
        n2 = state["n_frames"][:, None] + k_incl
        mean_sq = torch.stack(sums, dim=1) / torch.clamp(n2, min=1) / ws4
        ballast = o.nccf_ballast * mean_sq
        scale = torch.sqrt(e0 / (e0 + ballast * ws4 + 1e-10))
        obs = nccf * scale[..., None] * self._lag_bias

        # the Viterbi recursion: the only per-frame work that needs the
        # previous frame's result
        fwd, lags, two = state["fwd"], [], []
        trans = self._trans[None]
        for f in range(F):
            fwd2 = torch.amin(fwd[:, :, None] + trans, dim=1) - obs[:, f]
            low, lag = torch.min(fwd2, dim=1, keepdim=True)
            fwd = torch.where(v[:, f, None], fwd2 - low, fwd)
            lags.append(lag)
            if gaps:
                two.append(torch.topk(fwd2, 2, dim=1, largest=False).values)
        lag_idx = torch.cat(lags, dim=1)  # [B, F]

        c = torch.gather(nccf, 2, lag_idx[..., None])[..., 0].clamp(-1.0, 1.0)
        # pow in float64, rounded once to f32: a CPU's vectorised f32 pow
        # and its scalar tail differ in the last bit, and the chunking
        # moves frames between the two
        pov_feat = (o.pov_scale * (torch.pow(1.0001 - c.double(), 0.15) - 1.0)).float()
        pov = c.abs().clamp(0.0, 1.0)
        logp = self._neg_log_lags[lag_idx]

        # this chunk's valid frames by ordinal j (0, 1, ...) in a [B, F + 1]
        # row (column F takes the invalid frames' writes and is never read)
        B = v.shape[0]
        dump = torch.where(v, k_excl, F).long()
        ord_logp = torch.zeros((B, F + 1), dtype=torch.float32, device=v.device)
        ord_w = torch.zeros_like(ord_logp)
        ord_logp.scatter_(1, dump, logp)
        ord_w.scatter_(1, dump, pov + 1e-4)

        # the ring after frame f: valid frame j sits in slot (pos0 + j) % MW,
        # so slot s holds the chunk's ordinal K - 1 - ((pos0 + K - 1 - s) mod
        # MW) (K = valid frames up to f) when that is >= 0, else what the
        # carried ring held
        pos0 = state["ring_pos"]
        s = torch.arange(MW, dtype=torch.int32, device=v.device)
        K = k_incl[..., None]
        j = K - 1 - torch.remainder(pos0[:, None, None] + K - 1 - s, MW)  # [B, F, MW]
        jc = j.clamp(min=0).reshape(B, -1).long()
        mine = j >= 0
        r_logp = torch.where(mine, torch.gather(ord_logp, 1, jc).reshape(j.shape),
                             state["ring_logp"][:, None, :])
        r_w = torch.where(mine, torch.gather(ord_w, 1, jc).reshape(j.shape),
                          state["ring_w"][:, None, :])
        mean = (r_w * r_logp).sum(dim=-1) / torch.clamp(r_w.sum(dim=-1), min=1e-8)
        norm_logp = logp - mean

        # delta against the last valid frame before f (or the carried one)
        prev = torch.where(k_excl > 0,
                           torch.gather(ord_logp, 1, (k_excl - 1).clamp(min=0).long()),
                           state["prev_logp"][:, None])
        n_before = state["n_frames"][:, None] + k_excl
        delta = torch.where(n_before > 0, logp - prev, 0.0)

        feats = torch.stack([pov_feat, norm_logp, delta], dim=-1)
        feats = torch.where(v[..., None], feats, 0.0)

        k_all = k_incl[:, -1]
        state2 = {
            "fwd": fwd,
            "ring_logp": r_logp[:, -1].contiguous(),
            "ring_w": r_w[:, -1].contiguous(),
            "ring_pos": pos0 + k_all,
            "e_sum": e_sum,
            "n_frames": state["n_frames"] + k_all,
            "prev_logp": torch.where(
                k_all > 0, torch.gather(ord_logp, 1, (k_all - 1).clamp(min=0).long()[:, None])[:, 0],
                state["prev_logp"]),
        }
        if gaps:
            two = torch.stack(two, dim=1)
            return state2, feats, lag_idx, two[..., 1] - two[..., 0]
        return state2, feats, lag_idx
