"""Band-limited streaming resampler.

Copy of `vosk_tpu/ops/resample.py` (numpy only), kept in the port because
nothing under `vosk_tpu` imports without jax; tests/test_torch_copies.py
holds it to its source.

Role of Kaldi's LinearResample in the reference (batch_recognizer.cc:27-29
creates one per stream; recognizer input at a non-model rate goes through
it).  Same construction as Kaldi's feat/resample.cc:

  * windowed-sinc low-pass at cutoff = 0.99 * Nyquist of the lower rate
  * raised-cosine (Hann) window spanning num_zeros filter zeros
  * output n sits at time n / out_rate; its value is the dot product of the
    filter with the input samples inside the window support

and, unlike a per-buffer np.interp, it is STATEFUL: the fractional stream
position and the filter half-width of input history carry across process()
calls, so arbitrarily chunked streaming input yields bit-identical output
to one offline call (chunk-size invariance is tested).
"""
from __future__ import annotations

import numpy as np


class StreamingResampler:
    def __init__(self, in_rate: float, out_rate: float, num_zeros: int = 10):
        if in_rate <= 0 or out_rate <= 0:
            raise ValueError("rates must be positive")
        self.in_rate = float(in_rate)
        self.out_rate = float(out_rate)
        self.identity = abs(in_rate - out_rate) < 1e-6
        self.num_zeros = num_zeros
        # cutoff a hair under the lower Nyquist (Kaldi uses 0.99 * min/2)
        self.cutoff = 0.99 * 0.5 * min(self.in_rate, self.out_rate)
        # filter half-width in input samples
        self.W = int(np.ceil(num_zeros * self.in_rate / (2.0 * self.cutoff)))
        self.reset()

    def reset(self) -> None:
        self._hist = np.zeros(0, np.float32)  # unconsumed input tail
        self._in_pos = 0  # absolute index of _hist[0] in the input stream
        self._out_pos = 0  # next output sample index

    def _filter(self, d: np.ndarray) -> np.ndarray:
        """Hann-windowed sinc, d in seconds (Kaldi FilterFunc)."""
        half_width = self.num_zeros / (2.0 * self.cutoff)
        inside = np.abs(d) < half_width
        win = np.where(
            inside, 0.5 * (1.0 + np.cos(np.pi / half_width * d)), 0.0
        )
        # sinc low-pass: 2*cutoff*sinc(2*cutoff*d); limit at d=0 is 2*cutoff
        x = 2.0 * self.cutoff * d
        sinc = np.where(
            x == 0.0, 1.0, np.sin(np.pi * x) / np.where(x == 0.0, 1.0, np.pi * x)
        )
        return (2.0 * self.cutoff / self.in_rate) * win * sinc

    def process(self, wave: np.ndarray) -> np.ndarray:
        """Feed a chunk; returns all output samples computable so far."""
        wave = np.asarray(wave, np.float32)
        if self.identity:
            return wave
        buf = np.concatenate([self._hist, wave]) if len(self._hist) else wave
        total_in = self._in_pos + len(buf)
        ratio = self.in_rate / self.out_rate
        # output n needs input samples up to floor(n*ratio) + W
        n_hi = int(np.floor((total_in - 1 - self.W) / ratio)) + 1
        n0 = self._out_pos
        if n_hi <= n0:
            self._hist, out = buf, np.zeros(0, np.float32)
        else:
            n = np.arange(n0, n_hi, dtype=np.int64)
            center = n * ratio  # in input-sample units
            base = np.floor(center).astype(np.int64)
            k = np.arange(-self.W, self.W + 1, dtype=np.int64)
            idx = base[:, None] + k[None, :]
            # leading context before stream start is implicit zeros
            local = idx - self._in_pos
            valid = (local >= 0) & (local < len(buf))
            samp = np.where(valid, buf[np.clip(local, 0, len(buf) - 1)], 0.0)
            d = (idx - center[:, None]) / self.in_rate
            out = (samp * self._filter(d)).sum(axis=1).astype(np.float32)
            self._out_pos = n_hi
            # keep the history any future output can still touch
            keep_from = max(int(np.floor(n_hi * ratio)) - self.W, self._in_pos)
            self._hist = buf[keep_from - self._in_pos :]
            self._in_pos = keep_from
        return out

    def flush(self) -> np.ndarray:
        """Emit the remaining tail as if the stream ended (zero padding)."""
        if self.identity:
            return np.zeros(0, np.float32)
        n_in = self._in_pos + len(self._hist)
        pad = np.zeros(self.W + int(np.ceil(self.in_rate / self.out_rate)) + 1,
                       np.float32)
        # cap output at round(total_in * out/in) like an offline resample
        n_total = int(round(n_in * self.out_rate / self.in_rate))
        out = self.process(pad)
        keep = max(0, n_total - (self._out_pos - len(out)))
        return out[:keep]


def resample_offline(
    wave: np.ndarray, in_rate: float, out_rate: float, num_zeros: int = 10
) -> np.ndarray:
    """One-shot band-limited resample (streaming machinery, single call)."""
    r = StreamingResampler(in_rate, out_rate, num_zeros)
    a = r.process(np.asarray(wave, np.float32))
    b = r.flush()
    return np.concatenate([a, b]) if len(b) else a
