"""Native model-directory format (JSON config + npz arrays).

Port of `vosk_tpu/io/native.py` (`ModelConfig`, `EndpointRule`,
`save_model`, `load_model`, `load_any`): the directory layout is the
same, so a model saved by either package loads in both, lexicon and
topology included.  `NativeModel`'s factories return the port's torch
objects on the model's device.  `load_any` also opens Kaldi V1/V2 model
directories (io/kaldi_loader.py), which converge on the same `NativeModel`
with an nnet3 AM (`am_override`), an optional i-vector extractor and, for
split graphs, the HCLr pieces runtime grammars recompose.

Rescoring resources load as in the source: the graph LM `g.npz` (the LM
to subtract), `rescore.arpa` (the big LM to add) and a GRU `rnnlm/` on the
model's device (runtime/finishing.py rescores with them).  `pitch_opts`
adds online pitch to the features (ops/pitch.py).  A native TDNN-F with
an i-vector input, not ported yet, raises at `make_am` instead of decoding
without it.  As in the source, a native directory's `ivector/` is not
read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from collections import Counter, OrderedDict, deque
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..graph.builder import Lexicon, Topology
from ..graph.fst import DecodingGraph, StdFst, SymbolTable
from ..models.tdnnf import TdnnfConfig
from ..ops import features as F

FORMAT_VERSION = 1
CONFIG_NAME = "vosk_tpu_model.json"
# runtime-grammar decoders kept per model, least recently used dropped first
# (the source's cache has no bound)
GRAMMAR_DECODERS = 8


@dataclasses.dataclass
class EndpointRule:
    must_contain_nonsilence: bool
    min_trailing_silence: float
    max_relative_cost: float
    min_utterance_length: float = 0.0


def default_endpoint_rules() -> List[EndpointRule]:
    """Kaldi OnlineEndpointConfig defaults with the reference's overrides
    (src/model.cc:142-145)."""
    inf = float("inf")
    return [
        EndpointRule(False, 5.0, inf),
        EndpointRule(True, 0.5, 2.0),
        EndpointRule(True, 1.0, 8.0),
        EndpointRule(True, 2.0, inf),
        EndpointRule(False, 0.0, inf, 20.0),
    ]


@dataclasses.dataclass
class ModelConfig:
    sample_rate: float = 16000.0
    feature_type: str = "mfcc"  # mfcc | fbank
    frame_opts: dict = dataclasses.field(default_factory=dict)
    mel_opts: dict = dataclasses.field(default_factory=dict)
    mfcc_opts: dict = dataclasses.field(default_factory=dict)
    am: dict = dataclasses.field(default_factory=dict)
    pitch_opts: Optional[dict] = None
    beam: float = 13.0
    max_active: int = 7000
    lattice_beam: float = 6.0
    acoustic_scale: float = 1.0
    endpoint_rules: Optional[list] = None
    frame_shift_seconds: float = 0.03  # output-frame shift (0.01 * subsample)


# the most recognizers whose chunks step together.  Every combined step
# (runtime/recognizer.py `combined_step`) runs at this many rows, the rows no
# recognizer filled masked, so that its shapes, and with them each product's
# kernel and rounding, are the same however many streams joined: on an H100
# a row's features and ll at 3 or 4 rows differ in their last bits from the
# same row's at 1 (PERF.md §6).  4 holds the concurrency measured (4 C
# threads, 4 server clients) at the least cost to a stream alone
STEP_ROWS = 4


class StepCombiner:
    """The turns of one model's recognizers at the device, and flat
    combining of their steps.

    `turn(group)` holds the model's `turn_lock`, granted in the order it was
    asked for, and counts a call of `group` (the decoder of the recognizer
    that asked).  Recognizer calls run in turns, so that only one thread at
    a time runs Python: threads interleaving their many short torch calls
    thrash the interpreter lock (PERF.md §6).

    `run(key, group, job, step)`, in a turn, queues `job` under its key (the
    decoder and the kind of step).  If no step of that key is running, the
    thread leads.  Its step first lets the calls already waiting for a turn
    go (they may queue jobs), and lets them go again, round after round,
    while a round ran a call of `group`: such a call may have buffered
    audio, and its thread is then about to come back with a chunk.  A round
    waits only for calls that already asked for a turn, so a thread alone
    steps at once, and at most 2 * `rows` rounds run.  The step then takes
    the oldest queued jobs of the key, at most `rows`, runs `step` on them
    and wakes their threads.  Jobs queued during a step are taken by a new
    leader, one of their threads.  A recognizer's thread waits for its own
    job, so a step holds at most one job of each recognizer.  If the step
    raises, every job of it raises the same exception, and the next step
    runs as usual.  Waiting, for a turn or a step, is a wait on a Condition
    over `turn_lock`, which lets the turn go and releases the interpreter
    lock; only the thread that can go on is woken.  `sizes` counts the
    steps run by their number of jobs."""

    rows = STEP_ROWS

    def __init__(self, turn_lock):
        self.turn_lock = turn_lock
        self._ticket_lock = threading.Lock()
        self._asked = 0                    # tickets handed out, in the order asked
        self._now = 0                      # the ticket whose turn is next
        self._dropped: set = set()         # tickets given up while waiting
        self._waiting: Dict[int, threading.Condition] = {}  # ticket -> its waiter
        self._calls: Counter = Counter()   # group -> calls granted a turn
        self._queues: Dict[object, deque] = {}
        self._leading: set = set()
        self.sizes: Counter = Counter()

    @contextlib.contextmanager
    def turn(self, group=None):
        """Hold the model's turn, granted in the order asked for, for a
        call of `group`."""
        ticket = self._ticket()
        with self.turn_lock:
            self._wait_turn(ticket)
            self._calls[group] += 1
            yield

    def _ticket(self) -> int:
        with self._ticket_lock:
            self._asked += 1
            return self._asked - 1

    def _wait_turn(self, ticket: int) -> None:
        """With turn_lock held: wait, letting it go, until `ticket` is the
        next to go; then pass the next turn on."""
        if ticket != self._now:
            cv = self._waiting[ticket] = threading.Condition(self.turn_lock)
            try:
                while ticket != self._now:
                    cv.wait()
            except BaseException:
                self._dropped.add(ticket)
                self._advance()
                raise
            finally:
                del self._waiting[ticket]
        self._now += 1
        self._advance()

    def _advance(self) -> None:
        while self._now in self._dropped:
            self._dropped.discard(self._now)
            self._now += 1
        cv = self._waiting.get(self._now)
        if cv is not None:
            cv.notify()

    def _rounds(self, queue, group) -> None:
        """The leader's rounds (see the class): each waits for the turns
        asked before it."""
        for _ in range(2 * self.rows):
            calls = self._calls[group]
            self._wait_turn(self._ticket())
            if self._calls[group] == calls or len(queue) >= self.rows:
                return

    def run(self, key, group, job, step) -> None:
        """In a turn: return once a step has run over `job`; raise what it
        raised."""
        entry = _Job(job, threading.Condition(self.turn_lock))
        queue = self._queues.setdefault(key, deque())
        queue.append(entry)
        while not entry.done:
            if key in self._leading:
                try:
                    entry.cv.wait()
                except BaseException:  # an interrupted wait leaves no job behind
                    if entry in queue:
                        queue.remove(entry)
                    raise
                continue
            self._leading.add(key)
            batch = []
            try:
                try:
                    self._rounds(queue, group)
                except BaseException:
                    queue.remove(entry)
                    raise
                batch = [queue.popleft() for _ in range(min(self.rows, len(queue)))]
                error = None
                try:
                    step([e.job for e in batch])
                except BaseException as e:  # every job of the step gets it
                    error = e
                self.sizes[len(batch)] += 1
                for e in batch:
                    e.done, e.error = True, error
            finally:
                self._leading.discard(key)
                # wake the step's threads, and the thread of the oldest job
                # left, which leads the next step
                for e in batch + list(queue)[:1]:
                    e.cv.notify()
                if not queue and self._queues.get(key) is queue:
                    del self._queues[key]
        if entry.error is not None:
            raise entry.error


class _Job:
    __slots__ = ("job", "cv", "done", "error")

    def __init__(self, job, cv):
        self.job, self.cv, self.done, self.error = job, cv, False, None


class NativeModel:
    """Loaded model: everything Recognizer/BatchPipeline need, with
    factories that build the torch pipeline stages on `device`."""

    def __init__(
        self,
        config: ModelConfig,
        am_params: Dict[str, np.ndarray],
        graph: DecodingGraph,
        words: SymbolTable,
        phones: SymbolTable,
        phone_of_pdf: np.ndarray,
        silence_pdfs: np.ndarray,
        device="cuda",
        lexicon: Optional[Lexicon] = None,
        topology: Optional[Topology] = None,
        am_override=None,
    ):
        if graph is None:
            raise ValueError("the batch path needs a model with a decoding graph")
        self.config = config
        self.device = torch.device(device)
        # a loaded nnet3 AM (Kaldi layouts) replaces the native TDNN-F
        self.am_override = am_override
        self.am_config = TdnnfConfig(**config.am) if config.am else None
        self.am_params = am_params
        self.graph = graph
        self.words = words
        self.phones = phones
        self.phone_of_pdf = phone_of_pdf
        self.silence_pdfs = silence_pdfs
        self.lexicon = lexicon
        self.topology = topology if topology is not None else Topology()
        self.g_fst = None        # word-level LM in the graph (rescoring subtracts it)
        self.rescore_lm = None   # big ARPA / const-ARPA LM (rescoring adds it)
        self.rnnlm = None        # native GRU RNNLM (mixed 0.5/0.5 with the big LM)
        self.rnnlm_rescorer = None  # Kaldi rnnlm/ (io/kaldi_rnnlm.py)
        self.word_boundary = None  # phone -> position map (Kaldi layouts only)
        self.global_cmvn_stats = None
        self.ivector = None  # IvectorDirConfig (reference model.cc:247-263)
        self.silence_weight = 1.0  # i-vector silence weighting (1.0 = off)
        self.silence_weight_phones: set = set()
        # split-graph resources (Kaldi HCLr/Gr dirs) for runtime grammars
        self.hcl_fst = None
        self.disambig_tids: list = []
        self.tid2pdf = None
        self._decoder = None
        self._stream_am = None
        self._grammar_decoders: "OrderedDict[str, object]" = OrderedDict()
        self._decoder_lock = threading.Lock()
        # recognizers of this model take turns (`combiner.turn(dec)`), and the
        # chunks that recognizers of one decoder wait with step together
        # (runtime/recognizer.py)
        self.turn_lock = threading.RLock()
        self.combiner = StepCombiner(self.turn_lock)

    def make_decoder(self, graph=None, optimize_graph=True, frame_step="auto"):
        """A new BatchViterbi over `graph` (the model's by default) with the
        model's search parameters, on the model's device."""
        from ..ops.viterbi import BatchViterbi, DecodeParams

        c = self.config
        return BatchViterbi(
            self.graph if graph is None else graph,
            DecodeParams(beam=c.beam, max_active=c.max_active,
                         lattice_beam=c.lattice_beam,
                         acoustic_scale=c.acoustic_scale),
            silence_pdfs=self.silence_pdfs,
            optimize_graph=optimize_graph,
            device=self.device,
            frame_step=frame_step,
        )

    def shared_decoder(self, graph=None, cache_key=None):
        """A BatchViterbi shared by the model's recognizers (load-time graph
        transform + device tables), built on first use, as the JAX
        package's `NativeModel.shared_decoder` builds it: `prepare_graph_v4`,
        then the v4 step where the prepared graph is eps-free (packed16 rows,
        or exact3 rows where pdf ids need more than 14 bits), else the v3
        step (exact3 rows, eps rounds), with lattice records; the CSR step
        where the prepared graph's rows pass PADDED_MAX_SLOTS.

        The main graph's decoder (graph None) is kept for the model's
        life.  Runtime-grammar recognizers pass their graph with the
        grammar string as `cache_key`; the last GRAMMAR_DECODERS of those
        are kept, least recently used dropped first."""
        with self._decoder_lock:
            if graph is None:
                if self._decoder is None:
                    self._decoder = self.make_decoder()
                return self._decoder
            dec = self._grammar_decoders.get(cache_key)
            if dec is None:
                dec = self.make_decoder(graph)
                self._grammar_decoders[cache_key] = dec
                while len(self._grammar_decoders) > GRAMMAR_DECODERS:
                    self._grammar_decoders.popitem(last=False)
            else:
                self._grammar_decoders.move_to_end(cache_key)
            return dec

    def make_am(self):
        """The streaming acoustic model: the loaded nnet3 network (shared,
        its weights already on the device) or a native TDNN-F."""
        if self.am_override is not None:
            return self.am_override
        from ..models.tdnnf import TdnnfModel

        return TdnnfModel(self.am_config, self.am_params, device=self.device)

    def stream_am(self):
        """The streaming AM the model's recognizers share (built on first
        use), as they share its decoder: the combined step runs one AM over
        every recognizer's rows."""
        with self._decoder_lock:
            if self._stream_am is None:
                self._stream_am = self.make_am()
            return self._stream_am

    def make_batch_am(self):
        """`make_am` for the batch paths (BatchPipeline, FusedPipeline),
        which carry no i-vector: a model with an i-vector input fails here,
        at construction, where the source fails at its first chunk."""
        am = self.make_am()
        if getattr(am, "has_ivector", False):
            raise ValueError(
                "model expects an i-vector input, which the batch path does not "
                "compute; serve it through Model + KaldiRecognizer"
            )
        return am

    def feature_extractor(self) -> F.FeatureExtractor:
        fo = F.FrameOptions(samp_freq=self.config.sample_rate, **self.config.frame_opts)
        mel = F.MelOptions(**self.config.mel_opts)
        if self.config.feature_type == "mfcc":
            opts = F.MfccOptions(frame_opts=fo, mel_opts=mel, **self.config.mfcc_opts)
        else:
            opts = F.FbankOptions(frame_opts=fo, mel_opts=mel)
        return F.FeatureExtractor(opts, pitch_opts=self.config.pitch_opts, device=self.device)

    def endpoint_rules(self) -> List[EndpointRule]:
        if self.config.endpoint_rules is None:
            return default_endpoint_rules()
        return [EndpointRule(**r) for r in self.config.endpoint_rules]

    def make_ivector_extractor(self, chunk_frames: int = 32):
        """Online i-vector extractor on the model's device when the model
        ships an ivector/ dir (reference model.cc:247-263); None
        otherwise."""
        if self.ivector is None:
            return None
        from ..ops.ivector import OnlineIvectorExtractor

        return OnlineIvectorExtractor(self.ivector, chunk_frames=chunk_frames,
                                      device=self.device)

    def find_word(self, word: str) -> int:
        """vosk_model_find_word parity (vosk_api.h:69-74)."""
        return self.words.find(word)


def _graph_to_npz(graph: DecodingGraph) -> dict:
    d = dataclasses.asdict(graph)
    for k in ("start", "num_states", "eps_depth", "max_em_out", "max_eps_out"):
        d[k] = np.int32(d[k])
    return d


def _graph_from_npz(z) -> DecodingGraph:
    ints = ("num_states", "start", "eps_depth", "max_em_out", "max_eps_out")
    return DecodingGraph(**{
        f.name: int(z[f.name]) if f.name in ints else z[f.name]
        for f in dataclasses.fields(DecodingGraph)
    })


def _save_std_fst(path, fst) -> None:
    """Store a word-level StdFst (the graph LM G used for rescoring
    subtraction, role of rescore/G.fst at reference model.cc:310-311)."""
    rows = [(s, il, ol, w, ns) for s in range(fst.num_states)
            for il, ol, w, ns in fst.arcs[s]]
    np.savez(path, arcs=np.asarray(rows, np.float64).reshape(-1, 5),
             finals=np.asarray(fst.final, np.float32), start=np.int32(fst.start))


def _load_std_fst(path) -> StdFst:
    z = np.load(path)
    f = StdFst()
    f.add_states(len(z["finals"]))
    f.set_start(int(z["start"]))
    for s, fw in enumerate(z["finals"]):
        if np.isfinite(fw):
            f.set_final(s, float(fw))
    for s, il, ol, w, ns in z["arcs"]:
        f.add_arc(int(s), int(il), int(ol), float(w), int(ns))
    return f


def save_model(
    path,
    config: ModelConfig,
    am_params: Dict[str, np.ndarray],
    graph: DecodingGraph,
    words: SymbolTable,
    phones: SymbolTable,
    phone_of_pdf,
    silence_pdfs,
    lexicon: Optional[Lexicon] = None,
    topology: Optional[Topology] = None,
    g_fst=None,
) -> None:
    """Write a native model dir, with the lexicon and topology when given
    (runtime grammars need both) and the graph LM `g_fst` as `g.npz` when
    given (rescoring subtracts it)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.asdict(config)
    cfg["format"] = FORMAT_VERSION
    if topology is not None:
        cfg["topology"] = dataclasses.asdict(topology)
    if lexicon is not None:
        cfg["silence_phone"] = lexicon.silence_phone
        cfg["silence_cost"] = lexicon.silence_cost
    (p / CONFIG_NAME).write_text(json.dumps(cfg, indent=2, default=float))
    np.savez(p / "am.npz", **am_params)
    np.savez(p / "graph.npz", **_graph_to_npz(graph))
    if g_fst is not None:
        _save_std_fst(p / "g.npz", g_fst)
    np.savez(
        p / "maps.npz",
        phone_of_pdf=np.asarray(phone_of_pdf, np.int32),
        silence_pdfs=np.asarray(silence_pdfs, np.int32),
    )
    words.write_text(p / "words.txt")
    phones.write_text(p / "phones.txt")
    if lexicon is not None:
        with open(p / "lexicon.txt", "w", encoding="utf-8") as f:
            for wid, prons in lexicon.prons.items():
                for pron in prons:
                    syms = " ".join(lexicon.phones.name(ph) for ph in pron)
                    f.write(f"{lexicon.words.name(wid)} {syms}\n")


def _read_lexicon(path, words, phones, silence_phone, silence_cost) -> Lexicon:
    prons: Dict[int, List[List[int]]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            wid = words.find(parts[0])
            pron = [phones.find(s) for s in parts[1:]]
            if wid > 0 and all(ph > 0 for ph in pron):
                prons.setdefault(wid, []).append(pron)
    return Lexicon(words=words, phones=phones, prons=prons,
                   silence_phone=silence_phone, silence_cost=silence_cost)


def load_any(path, device="cuda") -> NativeModel:
    """Load a model dir of any supported layout: the native format or
    Kaldi V1/V2 layouts (reference model.cc:106-128 probing)."""
    if (Path(path) / CONFIG_NAME).exists():
        return load_model(path, device=device)
    from .kaldi_loader import is_kaldi_model_dir, load_kaldi_model

    if is_kaldi_model_dir(path):
        return load_kaldi_model(path, device=device)
    return load_model(path, device=device)  # raises the standard error


def load_model(path, device="cuda") -> NativeModel:
    p = Path(path)
    cfg_path = p / CONFIG_NAME
    if not cfg_path.exists():
        raise FileNotFoundError(
            f"Folder '{path}' does not contain model files. Make sure you "
            "specified the model path properly."
        )
    raw = json.loads(cfg_path.read_text())
    topology = Topology(**raw.get("topology", {}))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    config = ModelConfig(**{k: v for k, v in raw.items() if k in fields})
    if config.endpoint_rules is not None:
        config.endpoint_rules = [
            {**r, "max_relative_cost": float(r["max_relative_cost"])}
            for r in config.endpoint_rules
        ]
    maps = np.load(p / "maps.npz")
    words = SymbolTable.read_text(p / "words.txt")
    phones = SymbolTable.read_text(p / "phones.txt")
    lexicon = None
    if (p / "lexicon.txt").exists():
        lexicon = _read_lexicon(p / "lexicon.txt", words, phones,
                                raw.get("silence_phone", 0),
                                raw.get("silence_cost", 0.7))
    model = NativeModel(
        config=config,
        am_params=dict(np.load(p / "am.npz")),
        graph=_graph_from_npz(np.load(p / "graph.npz")),
        words=words,
        phones=phones,
        phone_of_pdf=maps["phone_of_pdf"],
        silence_pdfs=maps["silence_pdfs"],
        device=device,
        lexicon=lexicon,
        topology=topology,
    )
    # rescoring resources (reference loads rescore/G.fst + G.carpa,
    # model.cc:308-314): graph LM to subtract + ARPA LM to add
    if (p / "g.npz").exists():
        model.g_fst = _load_std_fst(p / "g.npz")
    if (p / "rescore.arpa").exists():
        from ..graph.arpa import BackoffLm

        model.rescore_lm = BackoffLm.read_arpa(p / "rescore.arpa", words)
    if (p / "rnnlm" / "vosk_tpu_rnnlm.json").exists():
        from ..models.rnnlm import RnnlmModel

        model.rnnlm = RnnlmModel.load(p / "rnnlm", device=model.device)
    return model
