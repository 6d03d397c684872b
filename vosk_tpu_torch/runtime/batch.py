"""High-throughput batch transcription on one device, in PyTorch.

Port of `vosk_tpu/runtime/batch.py` (the reference's CUDA batch pipeline:
`BatchedThreadedNnet3CudaOnlinePipeline` + `CudaOnlinePipelineDynamicBatcher`,
src/batch_model.cc:69-96, src/batch_recognizer.cc).

One `BatchPipeline` owns B channel slots whose streaming states (feature
ring, AM context, decode frontier) live as batched tensors on the model's
device, as do each chunk's decoder records.  A host-side dynamic batcher
collects per-stream chunk pushes; each `step()` forms one fixed-shape
[B, S] batch (idle channels masked with n_samples=0) and advances features
-> TDNN-F -> token passing.  The host reads back, once per chunk, only the
valid-frame counts and the endpoint inputs ([B] each); finishing a stream
reads that channel's records.  Results are finalized per stream on
FinishStream (runtime/finishing.py, with LM rescoring when the model
carries it) and queued as JSON, mirroring vosk_batch_recognizer_*
semantics (vosk_api.h:310-346).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..graph.lattice import to_host
from ..io.native import NativeModel
from ..io.wav import pcm16_bytes_to_float
from . import jsonout
from .endpoint import endpoint_detected
from .finishing import Finisher


class BatchPipeline:
    """Shared fixed-B streaming pipeline over one model."""

    def __init__(
        self,
        model: NativeModel,
        max_batch_size: int = 32,
        reset_on_endpoint: bool = True,
    ):
        # full-f32 products for the DFT/mel/DCT and the AM layers, as the
        # reference computes them (these flags are process-wide)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.device = model.device
        self.B = max_batch_size
        # segment utterances at silence like the reference CUDA pipeline
        # (reset_on_endpoint, batch_model.cc:72); each segment's result is
        # queued separately
        self.reset_on_endpoint = reset_on_endpoint
        self.rules = model.endpoint_rules()
        self.ex = model.feature_extractor()
        self.am = model.make_batch_am()
        self.dec = model.shared_decoder()
        self._finisher = Finisher(model, self.dec)
        self.rate = model.config.sample_rate
        self.chunk_samples = int(0.2 * self.rate)
        self.max_feat_frames = self.ex.stream_max_frames(self.chunk_samples)

        self._lock = threading.RLock()
        self._feat_state = self.ex.init_stream_state(self.B, self.chunk_samples)
        self._am_state = self.am.init_stream_state(self.B, self.max_feat_frames)
        self._frontier = self.dec.init_frontier(self.B)
        self._records: List[List[dict]] = [[] for _ in range(self.B)]
        self._free = deque(range(self.B))
        self._chunks: Dict[int, deque] = {}  # channel -> pending np chunks
        self._streams: Dict[int, "BatchRecognizer"] = {}
        self._utt_frames = np.zeros(self.B, np.int64)
        self._frame_offset = np.zeros(self.B, np.int64)

    # ------------------------------------------------------------ streams

    def open_stream(self, rec: "BatchRecognizer") -> int:
        with self._lock:
            if not self._free:
                # process pending work until a slot frees (bounded churn)
                self.drain()
                if not self._free:
                    raise RuntimeError("no free channels")
            ch = self._free.popleft()
            self._chunks[ch] = deque()
            self._streams[ch] = rec
            self._utt_frames[ch] = 0
            self._frame_offset[ch] = 0
            self._reset_channel(ch)
            return ch

    @staticmethod
    def _set_row(state: dict, ch: int, fresh: dict) -> None:
        """Write a one-channel fresh state into row `ch` of the batched
        state, in place (no other tensor aliases these); nested states (the
        pitch tracker's) row by row too."""
        for k, v in state.items():
            if isinstance(v, dict):
                BatchPipeline._set_row(v, ch, fresh[k])
            else:
                v[ch] = fresh[k][0]

    def _reset_channel(self, ch: int) -> None:
        self._set_row(self._feat_state, ch,
                      self.ex.init_stream_state(1, self.chunk_samples))
        self._set_row(self._am_state, ch,
                      self.am.init_stream_state(1, self.max_feat_frames))
        self._set_row(self._frontier, ch, self.dec.init_frontier(1))
        self._records[ch] = []

    def close_stream(self, ch: int) -> None:
        with self._lock:
            self._chunks.pop(ch, None)
            self._streams.pop(ch, None)
            self._free.append(ch)

    def push(self, ch: int, chunk: np.ndarray) -> None:
        with self._lock:
            self._chunks[ch].append(chunk)

    def pending_chunks(self, ch: int) -> int:
        with self._lock:
            q = self._chunks.get(ch)
            return len(q) if q is not None else 0

    # -------------------------------------------------------------- step

    def step(self) -> bool:
        """Advance every channel by at most one chunk. Returns True if any
        work was done."""
        with self._lock:
            S = self.chunk_samples
            batch = np.zeros((self.B, S), np.float32)
            nsamp = np.zeros((self.B,), np.int32)
            any_work = False
            for ch, q in self._chunks.items():
                if q:
                    c = q.popleft()
                    batch[ch, : len(c)] = c
                    nsamp[ch] = len(c)
                    any_work = True
            if not any_work:
                return False
            self._feat_state, feats, fvalid = self.ex.extract_chunk(
                self._feat_state,
                torch.from_numpy(batch).to(self.device),
                n_samples=torch.from_numpy(nsamp).to(self.device),
            )
            self._am_state, ll, lvalid = self.am.process_chunk(
                self._am_state, feats, fvalid
            )
            self._advance_decoder(ll, lvalid, active_mask=nsamp > 0)
            return True

    def _advance_decoder(self, ll, lvalid, active_mask, check_endpoints=True) -> None:
        self._frontier, recs, best, bestf = self.dec.decode_chunk(
            self._frontier, ll, lvalid
        )
        nvalid = to_host(lvalid.sum(dim=1))
        for ch in range(self.B):
            if active_mask[ch] and ch in self._streams:
                self._records[ch].append(recs)
                self._utt_frames[ch] += int(nvalid[ch])
        if self.reset_on_endpoint and check_endpoints:
            best_np = to_host(best)
            bestf_np = to_host(bestf)
            trail, speech = self.dec.endpoint_info(self._frontier)
            for ch in list(self._streams):
                if active_mask[ch] and self._utt_frames[ch] > 0:
                    self._maybe_endpoint(
                        ch, best_np[ch], bestf_np[ch],
                        int(trail[ch]), bool(speech[ch]),
                    )

    def _maybe_endpoint(self, ch: int, best: float, best_final: float,
                        trailing: int, has_speech: bool) -> None:
        """O(1) endpoint inputs from device-tracked trailing silence (no
        per-channel host traceback)."""
        rel = float(best_final) - float(best)
        fired = endpoint_detected(
            self.rules,
            int(self._utt_frames[ch]),
            trailing,
            rel,
            self.model.config.frame_shift_seconds,
            has_speech,
        )
        if fired:
            result = self.finalize(ch)
            self._streams[ch]._results.append(result)
            # restart decoding for the next segment, keep feature/AM streams
            self._set_row(self._frontier, ch, self.dec.init_frontier(1))
            self._frame_offset[ch] += self._utt_frames[ch]
            self._utt_frames[ch] = 0
            self._records[ch] = []

    def drain(self) -> None:
        while self.step():
            pass

    # ------------------------------------------------------------- flush

    def flush_channel(self, ch: int) -> None:
        """Flush AM right-context for one channel (masked flush)."""
        with self._lock:
            mask = torch.zeros((self.B,), dtype=torch.bool, device=self.device)
            mask[ch] = True
            pad_feats, pad_valid = self.am.flush_inputs(self._am_state, mask)
            self._am_state, ll, lvalid = self.am.process_chunk(
                self._am_state, pad_feats, pad_valid
            )
            active = np.zeros((self.B,), bool)
            active[ch] = True
            self._advance_decoder(ll, lvalid, active_mask=active,
                                  check_endpoints=False)

    def finalize(self, ch: int) -> str:
        """Lattice-based result JSON for a finished stream: word timings
        with lattice-posterior confidences, or NLSML when the stream asked
        for it — matching the reference's lattice-callback path
        (batch_recognizer.cc:43-107: scale 0.9 -> align -> MBR -> JSON)."""
        with self._lock:
            paths = self._finisher.paths(
                self._records[ch], self._frontier, ch, n=1, use_final=True
            )
            off = int(self._frame_offset[ch])
            shift = self.model.config.frame_shift_seconds
            words = [
                jsonout.WordResult(
                    self.model.words.name(wid),
                    (off + f0) * shift,
                    (off + f1) * shift,
                    conf,
                )
                for (wid, f0, f1, conf) in (paths[0][1] if paths else [])
            ]
            stream = self._streams.get(ch)
            if stream is not None and stream._nlsml:
                conf = (
                    sum(w.conf for w in words) / len(words) if words else 1.0
                )
                return jsonout.nlsml_result([(words, conf)])
            return jsonout.final_result(words, show_words=True)


class BatchModel:
    """vosk_batch_model_new parity (vosk_api.h:310-319), on `device`."""

    def __init__(self, model_path=None, model_name=None, lang=None,
                 max_batch_size: int = 32, device="cuda"):
        from .. import _resolve_model_path
        from ..io import native

        path = _resolve_model_path(model_path, model_name, lang)
        self._model = native.load_any(path, device=device)
        self._pipeline = BatchPipeline(self._model, max_batch_size)

    def Wait(self) -> None:
        self._pipeline.drain()


class BatchRecognizer:
    """Per-stream front onto the shared pipeline
    (vosk_api.h:321-346, batch_recognizer.cc)."""

    def __init__(self, batch_model: BatchModel, sample_rate: float):
        self._pipeline = batch_model._pipeline
        self.sample_rate = float(sample_rate)
        # stateful band-limited resampler per stream, on the host, matching
        # the reference's per-stream Kaldi LinearResample
        # (batch_recognizer.cc:27-29,157-158)
        self._resampler = None
        if abs(self.sample_rate - self._pipeline.rate) > 1e-6:
            from ..ops.resample import StreamingResampler

            self._resampler = StreamingResampler(
                self.sample_rate, self._pipeline.rate
            )
        self._buffer = np.zeros(0, np.float32)
        self._results: deque = deque()
        self._channel: Optional[int] = None
        self._finished = False
        self._nlsml = False

    def _ensure_channel(self) -> int:
        if self._channel is None:
            self._channel = self._pipeline.open_stream(self)
        return self._channel

    def AcceptWaveform(self, data) -> None:
        if isinstance(data, (bytes, bytearray, memoryview)):
            wave = pcm16_bytes_to_float(bytes(data))
        else:
            wave = np.asarray(data, np.float32)
        if self._resampler is not None:
            wave = self._resampler.process(wave)
        ch = self._ensure_channel()
        self._buffer = np.concatenate([self._buffer, wave])
        S = self._pipeline.chunk_samples
        while len(self._buffer) >= S:
            self._pipeline.push(ch, self._buffer[:S])
            self._buffer = self._buffer[S:]

    def SetNLSML(self, nlsml: bool) -> None:
        self._nlsml = bool(nlsml)

    def FinishStream(self) -> None:
        if self._channel is None:
            return
        ch = self._channel
        if self._resampler is not None:
            tail = self._resampler.flush()
            if len(tail):
                self._buffer = np.concatenate([self._buffer, tail])
            self._resampler.reset()
        if len(self._buffer) > 0:
            self._pipeline.push(ch, self._buffer)
            self._buffer = np.zeros(0, np.float32)
        self._pipeline.drain()
        self._pipeline.flush_channel(ch)
        self._results.append(self._pipeline.finalize(ch))
        self._pipeline.close_stream(ch)
        self._channel = None
        self._finished = True

    def FrontResult(self) -> str:
        self._pipeline.drain()
        if not self._results:
            return ""
        return self._results[0]

    def Pop(self) -> None:
        if self._results:
            self._results.popleft()

    def Result(self) -> str:
        """Convenience (reference python binding pops after reading,
        python/vosk/__init__.py:225-229)."""
        r = self.FrontResult()
        self.Pop()
        return r

    def GetPendingChunks(self) -> int:
        if self._channel is None:
            return 0
        return self._pipeline.pending_chunks(self._channel)
