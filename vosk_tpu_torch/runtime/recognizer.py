"""Streaming Recognizer in PyTorch: the state machine of the reference
Recognizer (src/recognizer.h:43, src/recognizer.cc) over the port's
features -> acoustic model (native TDNN-F or a Kaldi nnet3 network, with
online i-vectors when the model ships them) -> token passing (the v4 step,
or the v3 step where the prepared graph keeps epsilon arcs).

Port of `vosk_tpu/runtime/recognizer.py`: states INITIALIZED / RUNNING /
ENDPOINT / FINALIZED (recognizer.h:36-41), endpoint rules, 0.2 s chunking
(recognizer.cc:305-311), frame-offset and sample bookkeeping for absolute
timestamps (recognizer.cc:196-223, 457-458), resampling of input at another
rate, bounded streaming memory (old record chunks fold into a frozen
best-path prefix and a spliced prefix lattice), and the JSON results.

The feature, i-vector, AM and decoder states and the decoder records stay
on the model's device as one-row tensors.  Recognizers of one decoder that
wait with a chunk at the same time step it together: the model's
`StepCombiner` (io/native.py) gives one of their threads every waiting
chunk, and `combined_step` runs features, i-vectors, AM and decoder once
over STEP_ROWS rows, the rows nobody filled masked; each recognizer then
keeps its own rows and does its own bookkeeping.  The step's shapes do not
depend on how many streams joined, so a stream gets, bit for bit, what it
gets alone.  The host reads back once per step: one small tensor with each
row's decoded-frame count, best and best-final costs, best token's
trailing-silence word and, with i-vectors, the extractor's count of
accumulated frames.  Decoded-silence
weighting of the i-vector statistics (reference recognizer.cc:226-237)
traces back the newest chunk once per `AcceptWaveform`, as the source
does.  Results read the records they need.  Recognizers of one model share
its decoder (`NativeModel.shared_decoder`), as the reference shares its
Model.  Runtime grammars recompile L o G from a native model's lexicon, or
recompose HCLr o G on a split-graph Kaldi model.

With online pitch (a model's pitch.conf), FinalResult flushes the pitch
lookahead against zeros, as the source does, and the i-vector extractor
reads the base features without the pitch dims, as Kaldi's
OnlineNnet2FeaturePipeline feeds it (the source feeds it every dim;
ROADMAP C).  With a speaker model (`spk_model`, or `set_spk_model` before
the first audio), the utterance's audio is kept on the host and FinalResult
adds the source's `spk` x-vector and `spk_frames` (models/xvector.py).
"""
from __future__ import annotations

import enum
import functools
import json
import math
import weakref
from typing import List, Optional

import numpy as np
import torch

from ..graph.builder import build_decoding_graph
from ..graph.lattice import to_host
from ..graph.lm import grammar_to_fst
from ..io.native import STEP_ROWS, NativeModel
from ..io.wav import pcm16_bytes_to_float
from ..ops.viterbi import split_tsil
from ..utils.logging import log_warn
from ..utils.metrics import StageTimers
from . import endpoint as ep
from . import jsonout


def _in_turn(method):
    """`method` in its model's turn (`NativeModel.combiner.turn`), a call of
    the recognizer's decoder."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        with self.model.combiner.turn(self.dec):
            return method(self, *args, **kw)
    return run


class _Part:
    """One recognizer's share of a combined step: its chunk (None for the
    end-of-stream flush of the AM's right context) and the chunk's valid
    samples; the step fills in the recognizer's rows of the new states, its
    records, its values of the host read and the step's stage times."""

    __slots__ = ("rec", "chunk", "n_valid", "states", "records", "head", "times")

    def __init__(self, rec, chunk=None, n_valid=0):
        self.rec, self.chunk, self.n_valid = rec, chunk, n_valid


_IDLE = weakref.WeakKeyDictionary()   # decoder -> the masked rows' states


def _idle_rows(rec) -> dict:
    """States of STEP_ROWS - 1 fresh streams, which pad a step's rows (masked:
    no samples, no valid frame, as BatchPipeline masks an idle channel); one
    set per decoder, built on its first step."""
    idle = _IDLE.get(rec.dec)
    if idle is None:
        n = STEP_ROWS - 1
        idle = _IDLE[rec.dec] = {
            "feat": rec.ex.init_stream_state(n, rec.chunk_samples),
            "iv": rec.iv.init_state(n) if rec.iv is not None else None,
            "am": rec.am.init_stream_state(n, rec.max_feat_frames),
            "frontier": rec.dec.init_frontier(n),
        }
    return idle


def _stack(rows, idle):
    """Batch-first states (nested ones, as the pitch tracker's, too) of the
    step's recognizers, one row each, then idle rows up to STEP_ROWS."""
    pad = STEP_ROWS - len(rows)
    return {k: _stack([r[k] for r in rows], v) if isinstance(v, dict)
            else torch.cat([r[k] for r in rows] + [v[:pad]])
            for k, v in idle.items()}


def _row(state, i):
    """Row i of a batch-first state, as a one-row view."""
    return {k: _row(v, i) if isinstance(v, dict) else v[i:i + 1]
            for k, v in state.items()}


def combined_step(parts: List[_Part]) -> dict:
    """One step of the device pipeline over the chunks of `parts`, at most
    STEP_ROWS recognizers of one decoder (all with a chunk, or all flushing
    the AM's right context at the end of their input): features, i-vectors
    and AM, then `decode_chunk`, over STEP_ROWS rows, and one host read for
    every row.  Each part gets its rows of the new states (views), its
    record rows (copies, so that a recognizer retains what it retains alone)
    and its values of the read.  Returns the step's batched features, ll,
    their valid masks and frontier (for tests)."""
    r = parts[0].rec
    ex, iv, am, dec, dev = r.ex, r.iv, r.am, r.dec, r.device
    idle = _idle_rows(r)
    timers = StageTimers()
    iv_state = (_stack([p.rec._iv_state for p in parts], idle["iv"])
                if iv is not None else None)
    am_state = _stack([p.rec._am_state for p in parts], idle["am"])
    feats = fvalid = feat_state = ivec = None
    if parts[0].chunk is not None:
        S = r.chunk_samples
        audio = np.zeros((STEP_ROWS, S), np.float32)
        nsamp = np.zeros(STEP_ROWS, np.int32)
        for i, p in enumerate(parts):
            audio[i, :len(p.chunk)] = p.chunk
            nsamp[i] = p.n_valid
        with timers.timer("features"):
            feat_state, feats, fvalid = ex.extract_chunk(
                _stack([p.rec._feat_state for p in parts], idle["feat"]),
                torch.from_numpy(audio).to(dev), n_samples=torch.from_numpy(nsamp).to(dev))
        if iv is not None:
            with timers.timer("ivector"):
                # the base features: Kaldi's pipeline keeps pitch out of the
                # i-vector input
                iv_state = iv.update(iv_state, feats[..., :ex.base_dim], fvalid)
                ivec = iv.current(iv_state)
        with timers.timer("acoustic_model"):
            am_state, ll, lvalid = am.process_chunk(am_state, feats, fvalid, ivec)
    else:
        with timers.timer("acoustic_model"):
            if iv is not None:
                iv_state = iv.flush(iv_state)
                ivec = iv.current(iv_state)
            am_state, ll, lvalid = am.flush(am_state, ivec)
    with timers.timer("decoder"):
        frontier, recs, best, bestf = dec.decode_chunk(
            _stack([p.rec._frontier for p in parts], idle["frontier"]), ll, lvalid)
        # the step's one host read, a column a row: decoded frames, best and
        # best-final cost, the best token's packed trailing-silence word and
        # the i-vector frames accumulated (float64 holds each exactly)
        vals = [lvalid.sum(dim=1), best, bestf, dec.best_tsil(frontier)]
        if iv is not None:
            vals.append(iv_state["centers_done"])
        head = to_host(torch.stack([v.double() for v in vals], dim=1))
        axis = dec.record_lead("T", "B").index("B")
        for i, p in enumerate(parts):
            p.states = {
                "feat": _row(feat_state, i) if feat_state is not None else None,
                "iv": _row(iv_state, i) if iv_state is not None else None,
                "am": _row(am_state, i),
                "frontier": _row(frontier, i),
            }
            p.records = {k: v.narrow(axis, i, 1).clone(memory_format=torch.contiguous_format)
                         for k, v in recs.items()}
            p.head = head[i]
    for p in parts:
        p.times = timers.total_s
    return {"feats": feats, "fvalid": fvalid, "ll": ll, "lvalid": lvalid,
            "frontier": frontier}


class State(enum.Enum):
    INITIALIZED = 0
    RUNNING = 1
    ENDPOINT = 2
    FINALIZED = 3


# pipeline recycle threshold: ~10 minutes of decoded frames
# (reference recognizer.cc:196-202 uses 20000 decoded frames)
RECYCLE_FRAMES = 20000


class Recognizer:
    def __init__(
        self,
        model: NativeModel,
        sample_rate: float,
        grammar: Optional[str] = None,
        spk_model=None,
    ):
        # built in the model's turn: it puts the AM and the states on the
        # device
        with model.combiner.turn():
            self._build(model, sample_rate, grammar, spk_model)

    def _build(self, model, sample_rate, grammar, spk_model) -> None:
        self.model = model
        self.device = model.device
        self.sample_rate = float(sample_rate)
        # input at a different rate is resampled to the model's rate
        # (reference: allow_downsample in the feature pipeline, model.cc:221,
        # and LinearResample on the batch path, batch_recognizer.cc:27-29)
        self.model_rate = float(model.config.sample_rate)
        self._resampler = None
        self.spk_model = spk_model

        self.graph = model.graph
        # the grammar string, once a runtime-grammar graph is built from it
        self._grammar_key = None
        if grammar is not None:
            self._build_grammar_graph(grammar)

        # full-f32 products, as the batch pipeline sets them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ex = model.feature_extractor()
        self.am = model.stream_am()
        # the model's shared decoder (v4 or v3 step, lattice records), one
        # per runtime grammar
        self.dec = model.shared_decoder(
            graph=self.graph if self._grammar_key is not None else None,
            cache_key=self._grammar_key,
        )
        from .finishing import Finisher

        self._finisher = Finisher(model, self.dec)
        self.frame_shift = model.config.frame_shift_seconds
        self.rules = model.endpoint_rules()
        # bounded streaming memory: records older than this window are
        # folded into a frozen best-path prefix and a prefix lattice
        self.max_window_frames = 300
        self.keep_window_frames = 200

        # fixed device chunk: 0.2 s of samples (recognizer.cc:305)
        self.chunk_samples = int(0.2 * self.model_rate)
        self.max_feat_frames = self.ex.stream_max_frames(self.chunk_samples)

        # online i-vector extractor + decoded-silence weighting
        # (reference model.cc:247-263, recognizer.cc:226-237)
        self.iv = model.make_ivector_extractor(chunk_frames=self.max_feat_frames)
        self._silence_weight = float(model.silence_weight)
        swp = model.silence_weight_phones
        self._silence_weight_pdfs = (
            {
                int(pdf)
                for pdf in range(len(model.phone_of_pdf))
                if int(model.phone_of_pdf[pdf]) in swp
            }
            if swp
            else {int(x) for x in np.asarray(model.silence_pdfs)}
        )

        # result options
        self.words_ = False
        self.partial_words_ = False
        self.max_alternatives_ = 0
        self.nlsml_ = False

        # bookkeeping across utterances
        self.frame_offset_ = 0          # output frames finalized so far
        self.samples_processed_ = 0
        self.samples_round_start_ = 0

        from ..utils.metrics import StageTimers

        self.metrics = StageTimers()
        self._spk_feats: list = []      # the utterance's audio, for the speaker branch
        self._init_pipeline()
        self.state = State.INITIALIZED
        self.last_result_ = ""

    # ------------------------------------------------------------- setup

    def _build_grammar_graph(self, grammar: str) -> None:
        """Runtime phrase-list graph (reference recognizer.cc:49-98).

        Native models recompile L o G from their lexicon; split-graph Kaldi
        models (HCLr/Gr) recompose HCLr with a phrase-list G, the
        reference's LookaheadComposeFst(hcl, g, disambig) path."""
        hcl_fst = self.model.hcl_fst
        if self.model.lexicon is None and hcl_fst is None:
            log_warn("Runtime graphs are not supported by this model")
            return
        try:
            phrases = json.loads(grammar)
        except json.JSONDecodeError:
            phrases = []
        if not isinstance(phrases, list) or not phrases:
            log_warn(f"Expecting array of strings, got: '{grammar}'")
            return
        g = grammar_to_fst([str(p) for p in phrases], self.model.words.find)
        if self.model.lexicon is not None:
            self.graph, _ = build_decoding_graph(
                self.model.lexicon, g, self.model.topology
            )
        else:
            # the source builds this graph and then decodes with the main
            # graph's decoder (ROADMAP C); the port decodes with this one
            from ..graph.lookahead import lookahead_compose, prepare_decode_fst

            fst = lookahead_compose(hcl_fst, g, self.model.disambig_tids)
            self.graph = prepare_decode_fst(fst, self.model.tid2pdf)
        self._grammar_key = grammar

    def _init_pipeline(self) -> None:
        self._feat_state = self.ex.init_stream_state(1, self.chunk_samples)
        self._am_state = self.am.init_stream_state(1, self.max_feat_frames)
        self._iv_state = self.iv.init_state(1) if self.iv is not None else None
        self._iv_frames_weighted = 0    # silence weighting high-water mark
        self._iv_centers_done = 0       # the extractor's count, read per chunk
        self._frontier = self.dec.init_frontier(1)
        self._reset_utterance_records()
        self._pending = np.zeros(0, np.float32)
        self._best_cost = np.inf
        self._best_final_cost = np.inf
        self._flushed = False

    def _reset_utterance_records(self) -> None:
        self._records: list = []
        self._rec_frames: list = []     # decoded frames per retained chunk
        self._utt_frames = 0            # output frames decoded this utterance
        self._folded_frames = 0         # frames folded out of the window
        self._prefix_ols: list = []     # frozen (olabel, frame) before window
        self._prefix_pdfs: list = []    # frozen pdf alignment before window
        self._fold_init = None          # (states, costs) at the fold boundary
        self._prefix_lat = None         # windowed prefix LATTICE (alternatives
        self._prefix_slots = None       # survive folding); slot -> end node
        self._trailing, self._has_speech = 0, False

    # ---------------------------------------------------------- options

    def set_words(self, v: bool) -> None:
        self.words_ = bool(v)

    def set_partial_words(self, v: bool) -> None:
        self.partial_words_ = bool(v)

    def set_max_alternatives(self, n: int) -> None:
        self.max_alternatives_ = int(n)

    def set_nlsml(self, v: bool) -> None:
        self.nlsml_ = bool(v)

    def set_spk_model(self, spk_model) -> None:
        if self.state == State.RUNNING:
            raise RuntimeError("Can't add speaker model to already running recognizer")
        self.spk_model = spk_model

    # ------------------------------------------------------------ ingest

    @_in_turn
    def accept_waveform(self, data) -> bool:
        """Accept PCM data (bytes = s16le, or a numpy int16/float array).
        Returns True when an endpoint (silence) was detected
        (vosk_api.h:212-221).  Each 0.2 s chunk steps with the chunks that
        other recognizers of the decoder wait with."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            wave = pcm16_bytes_to_float(bytes(data))
        else:
            wave = np.asarray(data).astype(np.float32)
        if abs(self.sample_rate - self.model_rate) > 1e-6:
            # stateful band-limited resampler on the host (the reference's
            # per-stream LinearResample); phase carries across calls
            if self._resampler is None:
                from ..ops.resample import StreamingResampler

                self._resampler = StreamingResampler(
                    self.sample_rate, self.model_rate
                )
            wave = self._resampler.process(wave)
        return self._accept(wave)

    def _accept(self, wave: np.ndarray) -> bool:
        if self.state not in (State.RUNNING, State.INITIALIZED):
            self._clean_up()
        self.state = State.RUNNING

        if self.spk_model is not None:
            self._spk_feats.append(wave.copy())

        buf = np.concatenate([self._pending, wave])
        S = self.chunk_samples
        pos = 0
        while len(buf) - pos >= S:
            self._process_chunk(buf[pos : pos + S], S)
            pos += S
        self._pending = buf[pos:]
        self.samples_processed_ += len(wave)

        return self._endpoint_check()

    def _process_chunk(self, chunk: np.ndarray, n_valid: int) -> None:
        self.metrics.add_audio(n_valid / self.model_rate)
        self._step(_Part(self, chunk, n_valid))

    def _step(self, part: _Part) -> None:
        """Step `part` (this recognizer's chunk, or its AM flush) with the
        recognizers of its decoder that wait with theirs (`combined_step`
        through the model's StepCombiner), then take its rows (`_take`).
        Its stage timers get the times of the step it took part in."""
        kind = "flush" if part.chunk is None else "chunk"
        self.model.combiner.run((self.dec, kind), self.dec, part, combined_step)
        self._take(part)

    def _take(self, part: _Part) -> None:
        """This recognizer's rows of a step it took part in: its states,
        records, host values and stage times; then its bookkeeping (frame
        counts, costs, trailing silence, record fold)."""
        for stage, seconds in part.times.items():
            self.metrics.add(stage, seconds)
        st = part.states
        if st["feat"] is not None:
            self._feat_state = st["feat"]
        if st["iv"] is not None:
            self._iv_state = st["iv"]
        self._am_state, self._frontier = st["am"], st["frontier"]
        head = part.head
        n = int(head[0])
        self._records.append(part.records)
        self._rec_frames.append(n)
        self._utt_frames += n
        self._best_cost = float(np.float32(head[1]))
        self._best_final_cost = float(np.float32(head[2]))
        trailing, speech = split_tsil(np.array([int(head[3])]))
        self._trailing, self._has_speech = int(trailing[0]), bool(speech[0])
        if self.iv is not None:
            self._iv_centers_done = int(head[4])
        if self._utt_frames - self._folded_frames > self.max_window_frames:
            with self.metrics.timer("fold"):
                self._fold_records()

    def _fold_records(self) -> None:
        """Bound streaming memory: fold the oldest record chunks into a
        frozen best-path prefix (and the prefix lattice) so retained device
        records stay within keep_window_frames (the reference bounds
        lattice memory with incremental determinization, model.h:24)."""
        retained = self._utt_frames - self._folded_frames
        n_drop, drop_frames = 0, 0
        while (
            n_drop < len(self._records) - 1
            and retained - drop_frames > self.keep_window_frames
        ):
            drop_frames += self._rec_frames[n_drop]
            n_drop += 1
        if n_drop == 0 or drop_frames == 0:
            return
        _, ols, pdfs = self.dec.traceback_with_frames(
            self._records, self._frontier, 0, use_final=False,
            at_start=self._folded_frames == 0,
            init_states=self._window_init_states(),
        )
        self._prefix_ols += [
            (ol, f + self._folded_frames) for (ol, f) in ols if f < drop_frames
        ]
        self._prefix_pdfs += pdfs[:drop_frames]
        last = self._records[n_drop - 1]
        prev_init = self._fold_init
        if "pm" in last:  # v4 records: [T, B, K]
            self._fold_init = (
                to_host(last["state"][-1, 0]).copy(),
                to_host(last["f_cost"][-1, 0]).copy(),
            )
        else:  # v3 records: [B, T, L, K]
            self._fold_init = (
                to_host(last["f_state"][0, -1, -1]).copy(),
                to_host(last["f_cost"][0, -1, -1]).copy(),
            )
        self._extend_prefix_lattice(
            self._records[:n_drop], prev_init, self._fold_init
        )
        self._records = self._records[n_drop:]
        self._rec_frames = self._rec_frames[n_drop:]
        self._folded_frames += drop_frames

    def _extend_prefix_lattice(self, dropped, prev_init, boundary) -> None:
        """Windowed lattice: append the dropped record window's lattice to
        the retained prefix lattice so alternatives (n-best, confidences)
        survive folding; beam-pruned at each fold to bound memory."""
        from ..graph.lattice import build_lattice, splice_lattices

        fake_fr = {
            "state": np.asarray(boundary[0])[None, :],
            "cost": np.asarray(boundary[1])[None, :],
        }
        init_map: dict = {}
        try:
            lat_d, endmap = build_lattice(
                dropped, fake_fr, 0, self.dec, use_final=False,
                init_override=prev_init, init_map_out=init_map,
            )
        except Exception as e:  # never let prefix-lattice upkeep kill decode
            log_warn(f"prefix lattice build failed, freezing prefix: {e}")
            self._prefix_lat = None
            self._prefix_slots = None
            return
        if self._prefix_lat is None:
            self._prefix_lat, self._prefix_slots = lat_d, endmap
        elif self._prefix_slots is not None:
            self._prefix_lat, nmap = splice_lattices(
                self._prefix_lat, self._prefix_slots, lat_d, init_map,
                frame_offset=self._folded_frames,
            )
            self._prefix_slots = {k: nmap[n] for k, n in endmap.items()}
        if self._prefix_lat is not None and self._prefix_slots is not None:
            # bound memory: prune against the best boundary cost (finals
            # 0.0 on boundary nodes for the forward-backward, then cleared)
            lat = self._prefix_lat
            for node in self._prefix_slots.values():
                lat.final[node] = 0.0
            node_map: list = []
            pruned = lat.prune(
                self.dec.params.lattice_beam, node_map_out=node_map
            )
            if pruned is not lat:
                self._prefix_lat = pruned
                self._prefix_slots = {
                    k: node_map[n]
                    for k, n in self._prefix_slots.items()
                    if node_map[n] >= 0
                }
            for node in self._prefix_slots.values():
                self._prefix_lat.final[node] = math.inf

    def _window_init_states(self):
        """[K] graph-state row of the frontier just before the retained
        record window (the fold-boundary anchor of v4 tracebacks; v3
        records ignore it); None at utterance start."""
        if self._folded_frames == 0 or self._fold_init is None:
            return None
        return self._fold_init[0]

    def _last_chunk_init_states(self):
        """[K] state row just before the NEWEST record chunk (for the
        silence-weighting traceback over that chunk alone)."""
        if len(self._records) >= 2:
            prev = self._records[-2]
            if "pm" in prev:  # v4: [T, B, K]
                return to_host(prev["state"][-1, 0])
            return to_host(prev["f_state"][0, -1, -1])
        win = self._window_init_states()
        # single retained chunk at utterance start: the decoder's initial
        # closure is the preceding frontier
        return win if win is not None else self.dec._init_states

    def _full_traceback(self, use_final: bool):
        """Best path over the whole utterance: frozen prefix + retained
        window.  Returns (cost, ols_frames, pdfs) in utterance frames."""
        cost, ols, pdfs = self.dec.traceback_with_frames(
            self._records, self._frontier, 0, use_final=use_final,
            at_start=self._folded_frames == 0,
            init_states=self._window_init_states(),
        )
        off = self._folded_frames
        ols = self._prefix_ols + [(ol, f + off) for (ol, f) in ols]
        return cost, ols, self._prefix_pdfs + pdfs

    def _flush_pending(self, input_finished: bool) -> None:
        """Feed remaining buffered samples; on `input_finished` also flush
        the resampler and the AM right context (reference: InputFinished in
        FinalResult only, recognizer.cc:824-827; the endpoint Result() does
        not flush, so the feature/AM stream stays live)."""
        if input_finished and self._resampler is not None:
            tail = self._resampler.flush()
            if len(tail):
                self._pending = np.concatenate([self._pending, tail])
            self._resampler.reset()
        if input_finished and self.ex.flush_pad_samples:
            # pitch delays frame emission by its lookahead; flush the tail
            # frames against zeros (end-of-stream silence), like Kaldi's
            # online pitch at InputFinished
            self._pending = np.concatenate(
                [self._pending, np.zeros(self.ex.flush_pad_samples, np.float32)])
        # steps take chunks of chunk_samples: the resampler's tail and the
        # pitch pad may make the rest longer
        S = self.chunk_samples
        for pos in range(0, len(self._pending), S):
            piece = self._pending[pos: pos + S]
            self._process_chunk(piece, len(piece))
        self._pending = np.zeros(0, np.float32)
        if input_finished and not self._flushed:
            self._step(_Part(self))
            self._flushed = True

    # ---------------------------------------------------------- endpoint

    def _endpoint_check(self) -> bool:
        """O(1) endpoint check from the device-tracked trailing silence read
        with the last chunk (the reference reads equivalent decoder state
        at recognizer.cc:318)."""
        if self._utt_frames == 0:
            return False
        if (self.iv is not None and self._silence_weight != 1.0 and self._records
                and self._iv_centers_done > self._iv_frames_weighted):
            # silence weighting needs a frame alignment; a traceback over
            # just the newest chunk is O(chunk), not O(utterance), and only
            # when the extractor has frames not weighted yet
            _, _, pdfs = self.dec.traceback_with_frames(
                [self._records[-1]], self._frontier, 0, use_final=False,
                at_start=False, init_states=self._last_chunk_init_states(),
            )
            self._update_silence_weights(pdfs, self._utt_frames - len(pdfs))
        rel = self._best_final_cost - self._best_cost
        return ep.endpoint_detected(
            self.rules,
            self._utt_frames,
            self._trailing,
            rel,
            self.frame_shift,
            self._has_speech,
        )

    def _update_silence_weights(self, pdfs, frames_before: int = 0) -> None:
        """Downweight i-vector stats on frames the decoder aligned to
        silence (reference UpdateSilenceWeights, recognizer.cc:226-237).
        pdfs: best-path alignment of the utterance's decode frames starting
        at utterance frame `frames_before`.  The extractor's frame count
        comes from the chunk's host read (`_decode`)."""
        if self.iv is None or self._silence_weight == 1.0 or not pdfs:
            return
        ss = self.am.subsample
        n_feat = self._iv_centers_done
        sil = self._silence_weight_pdfs
        ids, ws = [], []
        for f in range(self._iv_frames_weighted, n_feat):
            d = f // ss - self.frame_offset_ - frames_before
            if 0 <= d < len(pdfs) and pdfs[d] in sil:
                ids.append(f)
                ws.append(self._silence_weight)
        self._iv_frames_weighted = n_feat
        if ids:
            # fixed width, as the source pads it for its jitted reweight
            N = self.iv.ring
            ids = (ids + [-1] * N)[:N]
            ws = (ws + [1.0] * N)[:N]
            self._iv_state = self.iv.reweight(
                self._iv_state,
                np.asarray([ids], np.int32),
                np.asarray([ws], np.float32),
            )

    # ----------------------------------------------------------- results

    def _clean_up(self) -> None:
        """Reference CleanUp (recognizer.cc:188-224): accumulate the frame
        offset; recycle the whole pipeline after FINALIZED or ~10 min, else
        just restart the decoder with the frame offset."""
        self.frame_offset_ += self._utt_frames
        if self.state == State.FINALIZED or self.frame_offset_ > RECYCLE_FRAMES:
            self.samples_round_start_ += self.samples_processed_
            self.samples_processed_ = 0
            self.frame_offset_ = 0
            self._spk_feats = []
            self._init_pipeline()
        else:
            # restart decoding from the start state, keep feature/AM streams
            self._frontier = self.dec.init_frontier(1)
            self._reset_utterance_records()
            self._best_cost = np.inf
            self._best_final_cost = np.inf

    def _word_results(self, olabels_with_frames) -> List[jsonout.WordResult]:
        """Word timing entries.  Times use the reference formula
        samples_round_start_/rate + (frame_offset_ + frame) * 0.03
        (recognizer.cc:457-458)."""
        base = self.samples_round_start_ / self.model_rate
        return [
            jsonout.WordResult(
                self.model.words.name(wid),
                base + (self.frame_offset_ + f_start) * self.frame_shift,
                base + (self.frame_offset_ + f_end) * self.frame_shift,
                conf,
            )
            for (wid, f_start, f_end, conf) in olabels_with_frames
        ]

    def _best_path_words(self, use_final: bool):
        """Traceback + word segmentation from the pdf alignment."""
        cost, ols, pdfs = self._full_traceback(use_final)
        return cost, self._segment_words(ols, pdfs), pdfs

    def _segment_words(self, ols_frames, pdfs):
        """(olabel, frame emitted) -> (wid, start_frame, end_frame, conf):
        a word runs to the next word's emission frame, trailing silence
        trimmed, then realigned by word-boundary phone types when the model
        has them (reference WordAlignLattice, recognizer.cc:435,752)."""
        from .wordalign import realign_items

        sil = set(int(x) for x in self.model.silence_pdfs)
        T = len(pdfs)
        items = []
        for i, (wid, f0) in enumerate(ols_frames):
            f1 = ols_frames[i + 1][1] if i + 1 < len(ols_frames) else T
            while f1 > f0 + 1 and pdfs[f1 - 1] in sil:
                f1 -= 1
            items.append((wid, f0, f1, 1.0))
        return realign_items(
            items, pdfs, self.model.phone_of_pdf, self.model.word_boundary
        )

    def _lattice_paths(self, n: int, use_final: bool):
        """n best lattice paths with word items and per-word posteriors via
        the shared Finisher.  Returns [(cost, [(wid, f0, f1, conf)])] in
        utterance frames."""
        if self._folded_frames > 0 and self._prefix_lat is not None:
            out = self._spliced_lattice_paths(n, use_final)
            if not out and use_final:
                out = self._spliced_lattice_paths(n, use_final=False)
            if out:
                return out  # frames already absolute; no prefix merge
        kw = dict(n=n, init_override=self._fold_init)
        out = self._finisher.paths(self._records, self._frontier, 0,
                                   use_final=use_final, **kw)
        if not out and use_final:
            # no complete final-state path inside the lattice beam: fall
            # back to non-final paths, like Kaldi's GetLattice
            # (use_final_probs=false) fallback
            out = self._finisher.paths(self._records, self._frontier, 0,
                                       use_final=False, **kw)
        return self._merge_prefix_paths(out)

    def _spliced_lattice_paths(self, n: int, use_final: bool):
        """Whole-utterance n-best and confidences across fold boundaries:
        the retained window's lattice spliced onto the prefix lattice
        (Python lattice, as in the source)."""
        from ..graph.lattice import build_lattice, splice_lattices

        init_map: dict = {}
        try:
            win_lat, _ = build_lattice(
                self._records, self._frontier, 0, self.dec,
                use_final=use_final, init_override=self._fold_init,
                init_map_out=init_map,
            )
            pre = self._prefix_lat.copy()
            lat, _ = splice_lattices(
                pre, dict(self._prefix_slots), win_lat, init_map,
                frame_offset=self._folded_frames,
            )
        except Exception as e:
            log_warn(f"spliced lattice failed, frozen-prefix fallback: {e}")
            return []
        return self._finisher.finish_lattice(lat, n)

    def _merge_prefix_paths(self, paths):
        """Shift window-relative word frames into utterance frames and
        prepend the frozen best-path prefix (its words keep conf 1.0)."""
        if self._folded_frames == 0:
            return paths
        prefix_items = [
            (wid, f0, f1, 1.0)
            for (wid, f0, f1, _c) in self._segment_words(
                self._prefix_ols, self._prefix_pdfs
            )
        ]
        off = self._folded_frames
        return [
            (cost, prefix_items
             + [(w, f0 + off, f1 + off, c) for (w, f0, f1, c) in items])
            for cost, items in paths
        ]

    def get_metrics(self) -> dict:
        """Per-stage timing report (host time; utils/metrics.py)."""
        return self.metrics.report()

    def _get_result(self) -> str:
        """Reference GetResult dispatch (recognizer.cc:669-728)."""
        if self._utt_frames == 0:
            return self._store_empty()
        if self.max_alternatives_ == 0:
            with self.metrics.timer("finishing"):
                paths = self._lattice_paths(1, use_final=True)
            if not paths:
                return self._store_empty()
            words = self._word_results(paths[0][1])
            spk_vec, spk_frames = self._speaker_vector()
            return jsonout.final_result(words, self.words_, spk_vec, spk_frames)
        paths = self._lattice_paths(self.max_alternatives_, use_final=True)
        if not paths:
            return self._store_empty()
        alts = [(self._word_results(items), -cost) for cost, items in paths]
        if self.nlsml_:
            return jsonout.nlsml_result(alts)
        return jsonout.nbest_result(alts, self.words_)

    def _speaker_vector(self):
        if self.spk_model is None:
            return None, None
        from ..models.xvector import extract_xvector_for_recognizer

        with self.metrics.timer("speaker"):
            return extract_xvector_for_recognizer(self)

    def _store_empty(self) -> str:
        if not self.max_alternatives_:
            self.last_result_ = '{"text": ""}'
        elif self.nlsml_:
            self.last_result_ = (
                '<?xml version="1.0"?>\n<result grammar="default">\n'
                '<interpretation confidence="1.0">\n<instance/>\n'
                "<input><noinput/></input>\n</interpretation>\n</result>\n"
            )
        else:
            self.last_result_ = '{"alternatives" : [{"text": "", "confidence" : 1.0}] }'
        return self.last_result_

    @_in_turn
    def result(self) -> str:
        """Finalize the current utterance after an endpoint
        (vosk_api.h:234-250)."""
        if self.state != State.RUNNING:
            return self._store_empty()
        self._flush_pending(input_finished=False)
        self.state = State.ENDPOINT
        self.last_result_ = self._get_result()
        return self.last_result_

    @_in_turn
    def partial_result(self) -> str:
        if self.state != State.RUNNING or self._utt_frames == 0:
            return jsonout.empty_partial()
        if self.partial_words_:
            # lattice path with posteriors (reference partial_words MBR
            # path, recognizer.cc:740-781)
            paths = self._lattice_paths(1, use_final=False)
            words = self._word_results(paths[0][1]) if paths else []
        else:
            _, words_items, _ = self._best_path_words(use_final=False)
            words = self._word_results(words_items)
        self.last_result_ = jsonout.partial_result(words, self.partial_words_)
        return self.last_result_

    @_in_turn
    def final_result(self) -> str:
        if self.state != State.RUNNING:
            return self._store_empty()
        self._flush_pending(input_finished=True)
        self.state = State.FINALIZED
        self.last_result_ = self._get_result()
        return self.last_result_

    def reset(self) -> None:
        self._store_empty()
        if self._resampler is not None:
            self._resampler.reset()
        self.state = State.ENDPOINT
