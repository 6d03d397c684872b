"""Streaming MFCC / log-mel filterbank feature extraction in PyTorch.

Port of `vosk_tpu/ops/features.py` (`FeatureExtractor._process_frames`,
`init_stream_state`, `_extract_chunk_impl`).  The numpy table functions are
copies of the source's.  Frames go through dense matmuls, as in the source:
  frames [N, padded_len] @ DFT_real/imag [padded_len, n_bins] -> power
  power [N, n_bins]      @ mel filterbank [n_bins, n_mels]    -> mel energies
  log-mel [N, n_mels]    @ DCT/lifter     [n_mels, n_ceps]    -> MFCC
Streaming is a carried ring of raw samples + a total-sample counter; each
fixed-size chunk yields a fixed (masked) number of frames.

The runtime never dithers (the source's runtime passes key=None), so the
`dither` option is read but not applied.  With `pitch_opts` (a model's
conf/pitch.conf) three online-pitch dims (ops/pitch.py) follow the base
features and frame emission waits for the pitch lookahead, as in the
source.  The offline `extract`, `sliding_window_cmn` and `global_cmvn`
(the speaker branch's features) are ported too.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class FrameOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    blackman_coeff: float = 0.42
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        n = self.window_size
        if self.round_to_power_of_two:
            p = 1
            while p < n:
                p *= 2
            return p
        return n


@dataclasses.dataclass
class MelOptions:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: offset from Nyquist


@dataclasses.dataclass
class MfccOptions:
    frame_opts: FrameOptions = dataclasses.field(default_factory=FrameOptions)
    mel_opts: MelOptions = dataclasses.field(default_factory=MelOptions)
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


@dataclasses.dataclass
class FbankOptions:
    frame_opts: FrameOptions = dataclasses.field(default_factory=FrameOptions)
    mel_opts: MelOptions = dataclasses.field(
        default_factory=lambda: MelOptions(num_bins=23)
    )
    use_energy: bool = False
    use_log_fbank: bool = True
    use_power: bool = True


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def num_frames_ready(num_samples, frame_opts: FrameOptions):
    """Number of complete (snip-edges) frames for a total sample count: an
    int, or an integer tensor of counts."""
    ws, sh = frame_opts.window_size, frame_opts.window_shift
    if isinstance(num_samples, (int, np.integer)):
        return 0 if num_samples < ws else (num_samples - ws) // sh + 1
    return torch.where(num_samples < ws, 0, (num_samples - ws) // sh + 1)


def feature_window(opts: FrameOptions) -> np.ndarray:
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    elif opts.window_type == "blackman":
        bc = opts.blackman_coeff
        w = bc - 0.5 * np.cos(a * i) + (0.5 - bc) * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {opts.window_type}")
    return w.astype(np.float32)


def mel_banks(mel_opts: MelOptions, frame_opts: FrameOptions) -> np.ndarray:
    """Triangular mel filterbank as a dense [n_fft_bins, num_bins] matrix."""
    nfft = frame_opts.padded_window_size
    nyquist = 0.5 * frame_opts.samp_freq
    low = mel_opts.low_freq
    high = mel_opts.high_freq if mel_opts.high_freq > 0 else nyquist + mel_opts.high_freq
    if not (0.0 <= low < nyquist and low < high <= nyquist):
        raise ValueError(f"bad mel range low={low} high={high} nyquist={nyquist}")

    nbins = nfft // 2 + 1
    fft_freqs = np.arange(nbins) * (frame_opts.samp_freq / nfft)
    mel_low, mel_high = mel_scale(low), mel_scale(high)
    mel_delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)
    mel_f = mel_scale(fft_freqs)

    mat = np.zeros((nbins, mel_opts.num_bins), dtype=np.float32)
    for j in range(mel_opts.num_bins):
        left = mel_low + j * mel_delta
        center = mel_low + (j + 1) * mel_delta
        right = mel_low + (j + 2) * mel_delta
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        mat[:, j] = np.maximum(0.0, np.minimum(up, down))
    return mat


def dft_matrices(nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices [nfft, nfft//2+1] (matmul-form rFFT)."""
    k = np.arange(nfft // 2 + 1)
    n = np.arange(nfft)
    ang = -2.0 * np.pi * np.outer(n, k) / nfft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Type-II DCT matrix (Kaldi normalization), shape [num_cols, num_rows]
    laid out for right-multiplication: mel [., M] @ dct -> ceps [., num_rows]."""
    m = np.arange(num_cols)
    mat = np.zeros((num_cols, num_rows), dtype=np.float64)
    mat[:, 0] = math.sqrt(1.0 / num_cols)
    for k in range(1, num_rows):
        mat[:, k] = math.sqrt(2.0 / num_cols) * np.cos(
            math.pi * k * (2 * m + 1) / (2 * num_cols)
        )
    return mat.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    k = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * k / q)).astype(np.float32)


_LOG_FLOOR = 1.1754944e-38  # FLT_MIN, Kaldi's log floor


class FeatureExtractor:
    """MFCC / fbank extractor with precomputed matmul tables on `device`,
    with optional online pitch (`pitch_opts`: a PitchOptions or a dict of
    its fields, the sample rate taken from the frame options)."""

    def __init__(self, opts: MfccOptions | FbankOptions, pitch_opts=None, device="cuda"):
        self.opts = opts
        self.device = torch.device(device)
        self.is_mfcc = isinstance(opts, MfccOptions)
        fo = opts.frame_opts
        self.frame_opts = fo
        self.nfft = fo.padded_window_size
        dft_re, dft_im = dft_matrices(self.nfft)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        self.window = dev(feature_window(fo))
        self.dft_re, self.dft_im = dev(dft_re), dev(dft_im)
        self.mel = dev(mel_banks(opts.mel_opts, fo))
        if self.is_mfcc:
            dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
            if opts.cepstral_lifter != 0.0:
                dct = dct * lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)[None, :]
            self.dct = dev(dct)
            self.dim = opts.num_ceps
        else:
            self.dim = opts.mel_opts.num_bins
        # optional online pitch appended to the base features (3 dims; the
        # reference adds Kaldi online pitch when conf/pitch.conf exists,
        # src/model.cc:265-276).  Frame emission is delayed by the pitch
        # lookahead so features stay chunk-invariant.
        self.pitch = None
        self.base_dim = self.dim
        self._pitch_la = 0
        if pitch_opts is not None:
            from .pitch import PitchOptions, StreamingPitch

            if isinstance(pitch_opts, dict):
                pitch_opts = PitchOptions(sample_rate=fo.samp_freq, **pitch_opts)
            self.pitch = StreamingPitch(pitch_opts, device=self.device)
            self.dim += 3
            self._pitch_la = self.pitch.la16

    @property
    def flush_pad_samples(self) -> int:
        """Zeros to append at end of input so lookahead-delayed frames (the
        pitch tail) are emitted; 0 without pitch."""
        return self._pitch_la

    def _process_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [..., n, window_size] -> feats [..., n, dim]."""
        opts, fo = self.opts, self.frame_opts
        x = frames.to(torch.float32)
        if fo.remove_dc_offset:
            x = x - x.mean(dim=-1, keepdim=True)
        raw_energy = (x * x).sum(dim=-1)  # pre-window energy (raw_energy)
        c = fo.preemphasis_coefficient
        if c != 0.0:
            prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
            x = x - c * prev
        x = x * self.window
        pad = self.nfft - fo.window_size
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        re = torch.matmul(x, self.dft_re)
        im = torch.matmul(x, self.dft_im)
        power = re * re + im * im
        mel_e = torch.matmul(power, self.mel)
        if self.is_mfcc:
            logmel = torch.log(torch.clamp(mel_e, min=_LOG_FLOOR))
            feats = torch.matmul(logmel, self.dct)
            if opts.use_energy:
                if opts.raw_energy:
                    e = torch.log(torch.clamp(raw_energy, min=_LOG_FLOOR))
                else:
                    e = torch.log(torch.clamp((x * x).sum(dim=-1), min=_LOG_FLOOR))
                if opts.energy_floor > 0.0:
                    e = torch.clamp(e, min=math.log(opts.energy_floor))
                feats = torch.cat([e[..., None], feats[..., 1:]], dim=-1)
            return feats
        if not opts.use_power:
            mel_e = torch.sqrt(torch.clamp(mel_e, min=0.0))
        if opts.use_log_fbank:
            mel_e = torch.log(torch.clamp(mel_e, min=_LOG_FLOOR))
        return mel_e

    # ---------------- offline (whole-utterance) ----------------

    def extract(self, wav) -> torch.Tensor:
        """wav: [..., num_samples] (array or tensor) -> feats [..., num_frames,
        dim] on the extractor's device (snip-edges frame count).

        With pitch, the streaming path runs over the whole utterance in one
        chunk with `flush_pad_samples` trailing zeros, so the frame count is
        the no-pitch one and any streaming split gives the same features,
        as in the source."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        fo = self.frame_opts
        N = wav.shape[-1]
        n = num_frames_ready(N, fo)
        if n <= 0:
            return torch.zeros(wav.shape[:-1] + (0, self.dim), dtype=torch.float32,
                               device=self.device)
        if self.pitch is not None:
            squeeze = wav.dim() == 1
            wav2 = wav[None] if squeeze else wav
            wavp = torch.nn.functional.pad(wav2, (0, self._pitch_la))
            st = self.init_stream_state(wavp.shape[0], wavp.shape[1])
            _, feats, _ = self.extract_chunk(st, wavp)
            feats = feats[:, :n]
            return feats[0] if squeeze else feats
        return self._extract_impl(wav, n)

    def _extract_impl(self, wav, n):
        fo = self.frame_opts
        idx = (torch.arange(n, device=wav.device)[:, None] * fo.window_shift
               + torch.arange(fo.window_size, device=wav.device)[None, :])
        return self._process_frames(wav[..., idx])  # [..., n, window_size]

    # ---------------- streaming ----------------

    def stream_max_frames(self, chunk_samples: int) -> int:
        return chunk_samples // self.frame_opts.window_shift + 1

    def init_stream_state(self, batch: int, chunk_samples: int) -> dict:
        """Carried state: raw-sample ring tail + counters (+ the pitch
        tracker's state under "pitch")."""
        cap = self._tail_cap(chunk_samples)
        z = dict(device=self.device)
        st = {
            "tail": torch.zeros((batch, cap), dtype=torch.float32, **z),
            "tail_len": torch.zeros((batch,), dtype=torch.int32, **z),
            "total_samples": torch.zeros((batch,), dtype=torch.int32, **z),
            "frames_emitted": torch.zeros((batch,), dtype=torch.int32, **z),
        }
        if self.pitch is not None:
            st["pitch"] = self.pitch.init_state(batch)
        return st

    def _tail_cap(self, chunk_samples: int) -> int:
        fo = self.frame_opts
        cap = max(fo.window_size + fo.window_shift, chunk_samples + fo.window_size)
        if self.pitch is not None:
            # pitch delays frame emission by la16 samples and its FIR needs
            # W16 samples of retained left context
            cap += self._pitch_la + self.pitch.W16
        return ((cap + 127) // 128) * 128

    def extract_chunk(self, state: dict, chunk: torch.Tensor, n_samples=None):
        """Streaming step. chunk: [B, S] fixed S -> (state', feats [B, F, dim],
        valid [B, F] bool) with F = stream_max_frames(S).  Masked frames are 0.
        n_samples: optional [B] int32 — only chunk[b, :n_samples[b]] is real
        data (prefix mask); defaults to S.
        """
        if n_samples is None:
            n_samples = torch.full((chunk.shape[0],), chunk.shape[1],
                                   dtype=torch.int32, device=chunk.device)
        return self._extract_chunk_impl(state, chunk, n_samples)

    def _extract_chunk_impl(self, state, chunk, n_samples):
        fo = self.frame_opts
        B, S = chunk.shape
        F = self.stream_max_frames(S)
        cap = state["tail"].shape[1]
        ws, sh = fo.window_size, fo.window_shift
        dev = chunk.device

        tail, tail_len = state["tail"], state["tail_len"]
        total, emitted = state["total_samples"], state["frames_emitted"]
        n_s = n_samples.to(torch.int32)

        # place the chunk at position tail_len per row of a [B, cap + S] buffer
        buf = torch.cat([tail, torch.zeros((B, S), dtype=torch.float32, device=dev)], dim=1)
        col = torch.arange(cap + S, dtype=torch.int32, device=dev)[None, :]
        src_idx = torch.clamp(col - tail_len[:, None], 0, S - 1)
        chunk_g = torch.gather(chunk.to(torch.float32), 1, src_idx.long())
        in_chunk = (col >= tail_len[:, None]) & (col < (tail_len + n_s)[:, None])
        buf = torch.where(in_chunk, chunk_g, buf)
        buf_len = tail_len + n_s

        new_total = total + n_s
        # with pitch, a frame is emitted only once its NCCF lookahead (plus
        # the decimation FIR's halfwidth) is buffered: chunk-invariance
        ready = new_total - self._pitch_la
        total_ready = num_frames_ready(ready, fo)
        n_new = (total_ready - emitted).to(torch.int32)  # <= F by construction

        # frame f starts at buffer offset (emitted + f) * sh - (new_total - buf_len)
        f_ids = torch.arange(F, dtype=torch.int32, device=dev)
        start = (emitted[:, None] + f_ids[None, :]) * sh - (new_total - buf_len)[:, None]
        valid = f_ids[None, :] < n_new[:, None]
        start_c = torch.clamp(start, 0, cap + S - ws)
        gather_idx = start_c[:, :, None] + torch.arange(ws, dtype=torch.int32, device=dev)
        frames = torch.gather(buf, 1, gather_idx.reshape(B, -1).long()).reshape(B, F, ws)
        feats = self._process_frames(frames)
        feats = torch.where(valid[:, :, None], feats, 0.0)

        pitch_state = None
        if self.pitch is not None:
            # pitch windows start where the MFCC windows start; the buffer
            # holds the full lookahead because ready-counting delayed the
            # frames (start is unclipped so pitch indexes real positions)
            pitch_state, pfeats = self.pitch.frame_features(
                state["pitch"], buf, start[:, 0], F, valid)
            feats = torch.cat([feats, torch.where(valid[:, :, None], pfeats, 0.0)], dim=2)

        # new tail: keep samples from (emitted + n_new) * sh onward (minus
        # the FIR left margin the next pitch frame's decimation needs)
        consumed_global = (emitted + n_new) * sh
        if self.pitch is not None:
            consumed_global = torch.clamp(consumed_global - self.pitch.W16, min=0)
        keep_from = torch.clamp(consumed_global - (new_total - buf_len), 0, cap + S)
        new_tail_len = torch.clamp(buf_len - keep_from, max=cap).to(torch.int32)
        tcol = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
        tsrc = torch.clamp(tcol + keep_from[:, None], 0, cap + S - 1)
        new_tail = torch.gather(buf, 1, tsrc.long())
        new_tail = torch.where(tcol < new_tail_len[:, None], new_tail, 0.0)

        new_state = {
            "tail": new_tail,
            "tail_len": new_tail_len,
            "total_samples": new_total,
            "frames_emitted": emitted + n_new,
        }
        if pitch_state is not None:
            new_state["pitch"] = pitch_state
        return new_state, feats, valid


# ---------------- CMVN ----------------


def sliding_window_cmn(feats: torch.Tensor, window: int = 300, center: bool = True,
                       norm_vars: bool = False) -> torch.Tensor:
    """Sliding-window cepstral mean normalization (Kaldi SlidingWindowCmn
    with center=true), used for speaker-ID features at reference
    recognizer.cc:393-397.  feats: [T, D] or [B, T, D], with cumulative
    sums over time (no loops), as the source's `_swc_single`."""
    T = feats.shape[-2]
    dev = feats.device
    pad = torch.zeros_like(feats[..., :1, :])
    cs = torch.cat([pad, torch.cumsum(feats, dim=-2)], dim=-2)  # [..., T+1, D]
    cs2 = torch.cat([pad, torch.cumsum(feats * feats, dim=-2)], dim=-2)
    t = torch.arange(T, device=dev)
    if center:
        lo = torch.clamp(t - window // 2, 0, T)
        hi = torch.clamp(lo + window, 0, T)
        lo = torch.where(hi - lo < window, torch.clamp(hi - window, 0, T), lo)
    else:
        lo = torch.clamp(t - window + 1, 0, T)
        hi = t + 1
    cnt = (hi - lo).to(torch.float32)[:, None]
    mean = (cs[..., hi, :] - cs[..., lo, :]) / cnt
    out = feats - mean
    if norm_vars:
        var = (cs2[..., hi, :] - cs2[..., lo, :]) / cnt - mean * mean
        out = out / torch.sqrt(torch.clamp(var, min=1e-10))
    return out


def global_cmvn(feats: torch.Tensor, stats: np.ndarray, norm_vars: bool = False) -> torch.Tensor:
    """Apply global CMVN from a Kaldi-style stats matrix [2, D+1] (row 0:
    sums, the count in the last column; row 1: sums of squares), as the
    source does; the statistics are reduced in numpy, as there."""
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    out = feats - torch.as_tensor(mean, dtype=feats.dtype, device=feats.device)
    if norm_vars:
        var = stats[1, :-1] / count - mean * mean
        out = out / torch.as_tensor(np.sqrt(np.maximum(var, 1e-10)), dtype=feats.dtype,
                                    device=feats.device)
    return out
