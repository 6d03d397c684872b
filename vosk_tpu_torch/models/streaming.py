"""Generic streaming wrapper for acoustic models, in PyTorch.

Port of `vosk_tpu/models/streaming.py` (`forward_utterance`,
`init_stream_state`, `_process_chunk_impl`, `_flush_impl`, and their
compiled `process_chunk` and `flush`).
Any module exposing
`forward(window [B, W, D], ivector [B, I] or None) -> [B, ceil(W/ss), P]`
with known left/right context and subsampling gets chunked streaming with
carried feature history, masked per-channel advance, and end-of-stream
flush.  The optional i-vector is passed through to every forward.  State
tensors live on the model's device.

The compiled chunk (the source's `jax.jit(self._process_chunk_impl)`,
:63-66, and `jax.jit(self._flush_impl)`, :122-125): on a CUDA device
`process_chunk` replays one captured CUDA graph per chunk shape
(`_AmChunkProgram`) where `graph_eligible` holds, and `flush` computes its
padding chunk (`flush_inputs`) and goes through `process_chunk`.  The graph
is the eager body (`_process_chunk_impl`: the history shift, the window
gather, the forward, the output mask) captured over static inputs; each
call copies the state, features, mask and i-vector in, replays, and copies
the new state, the outputs and their mask out into fresh tensors.  Eager by
rule, decided from the model and the call before any launch: the CPU, a
tensor-parallel TDNN-F (`mesh` set: its collectives go through gloo on the
host), a `trainable` model or any parameter that requires grad, and an
empty chunk.  `process_chunk_eager` runs the eager body on any device: the
card-side reference the captured program is held to.  A program reads the
weights where they lay when it was captured: they are updated in place
(`copy_`, `load_state_dict`), never moved, once the model has captured.
"""
from __future__ import annotations

import collections
import functools
import threading

import torch

# captured chunk programs an AM keeps (one per chunk shape), the least
# recently used dropped first
AM_CHUNK_PROGRAMS = 8
# the AMs' chunk programs: CUDA graphs captured and replays launched
GRAPH_COUNTS = {"captures": 0, "replays": 0}
STATE_KEYS = ("hist", "hist_len", "feats_seen", "out_emitted")


class StreamingAm:
    """Mixin for an `nn.Module`, listed before it among the bases: the
    subclass provides `feat_dim`, `subsample`, `left_context`,
    `right_context`, `device` and `forward(window, ivector=None)`, and calls
    `_own_programs()` in its constructor."""

    feat_dim: int
    subsample: int
    left_context: int
    right_context: int

    @property
    def _left_pad(self) -> int:
        ss = self.subsample
        return ((self.left_context + ss - 1) // ss) * ss

    def forward_utterance(self, feats: torch.Tensor, ivector=None) -> torch.Tensor:
        """Whole-utterance forward with Kaldi edge-copy padding: feats
        [B, T, D] -> [B, ceil(T/ss), P] (the source's `forward_utterance`;
        the trainers run it over their master parameters)."""
        ss = self.subsample
        Lp, R = self._left_pad, self.right_context
        T = feats.shape[1]
        n_out = -(-T // ss)
        need_right = max((n_out - 1) * ss + R + 1 - T, 0)
        window = torch.cat([feats[:, :1].expand(-1, Lp, -1), feats,
                            feats[:, -1:].expand(-1, need_right, -1)], dim=1)
        out = self.forward(window, ivector)
        return out[:, Lp // ss: Lp // ss + n_out]

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

    def _own_programs(self) -> None:
        """What the model keeps for its captured chunks: the dispatch lock
        (one call's copy-in, replay and copy-out at a time), the programs
        by key, least recently used first, and the side stream of each
        device, on which its programs are captured and replayed."""
        self._dispatch_lock = threading.RLock()
        self._programs = collections.OrderedDict()
        self._side_streams = {}

    def __getstate__(self):
        """Pickled (torch.save, which a mesh's ranks load) and copied
        without the lock, programs and side streams: a copy starts with
        none (a graph bakes in the addresses of the weights it read)."""
        st = dict(super().__getstate__())
        for k in ("_dispatch_lock", "_programs", "_side_streams", "_parameter_list"):
            st.pop(k, None)
        return st

    def __setstate__(self, st):
        super().__setstate__(st)
        self._own_programs()

    @property
    def graph_eligible(self) -> bool:
        """Whether `process_chunk` on CUDA tensors replays a captured chunk
        program: not a tensor-parallel TDNN-F (`mesh`), not a `trainable`
        one, and no parameter that requires grad."""
        return (getattr(self, "mesh", None) is None and not getattr(self, "trainable", False)
                and not any(p.requires_grad for p in self._parameter_list))

    @functools.cached_property
    def _parameter_list(self) -> list:
        """The model's parameters, listed once: the set is fixed when the
        model is built (walking the modules on every call costs tens of
        microseconds)."""
        return list(self.parameters())

    def process_chunk(self, state, feats, valid, ivector=None):
        """state: `init_stream_state`'s; feats [B, F, D]; valid [B, F] bool;
        ivector [B, I] or None.  Returns (new state, out [B, O, P] f32,
        out_valid [B, O] bool) with O = `stream_max_out(F)`.

        On CUDA tensors, where `graph_eligible`, the chunk replays the
        captured program of its shape (the first call of a shape captures
        it); what it returns is fresh.  Elsewhere, and for an empty chunk,
        the eager body (`process_chunk_eager`)."""
        B, F, _ = feats.shape
        if feats.is_cuda and B * F and self.graph_eligible:
            return self._replay(state, feats, valid, ivector)
        return self._process_chunk_impl(state, feats, valid, ivector)

    def process_chunk_eager(self, state, feats, valid, ivector=None):
        """`process_chunk` launched op by op on any device: the body that the
        captured chunk program holds, and its reference on the card."""
        return self._process_chunk_impl(state, feats, valid, ivector)

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

    def _program_key(self, state, feats, ivector) -> tuple:
        """A chunk program's key: (device, B, F, D, the history's length H,
        the i-vector's dim or None), the shapes a captured graph is fixed
        to."""
        B, F, D = feats.shape
        return (feats.device, B, F, D, state["hist"].shape[1],
                None if ivector is None else ivector.shape[-1])

    def _replay(self, state, feats, valid, ivector):
        """process_chunk through the captured program of the chunk's shape,
        captured on the first call of that shape.  Under the dispatch lock:
        copy-in on the caller's current stream, the replay on the model's
        side stream of the device (the capturing stream, whose cuBLAS
        workspace the graph's products name) fenced both ways against the
        caller's, copy-out on the caller's stream.  A failed capture or
        replay raises."""
        key = self._program_key(state, feats, ivector)
        dev = feats.device
        stream = torch.cuda.current_stream(dev)
        with self._dispatch_lock:
            side = self._side_streams.get(dev)
            if side is None:
                side = self._side_streams[dev] = torch.cuda.Stream(dev)
            prog = self._programs.get(key)
            if prog is None:
                prog = _AmChunkProgram(key)
                prog.load(state, feats, valid, ivector, stream)
                prog.capture(self, side, stream)
                self._programs[key] = prog
                if len(self._programs) > AM_CHUNK_PROGRAMS:
                    _, old = self._programs.popitem(last=False)
                    old.done.synchronize()  # its last call's work is done before it is freed
            else:
                self._programs.move_to_end(key)
                prog.load(state, feats, valid, ivector, stream)
            prog.replay(side, stream)
            return prog.unload(stream)

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

    def flush(self, state, ivector=None):
        """End-of-stream flush of every channel: `flush_inputs`' chunk
        through `process_chunk` (so on the card the replay of the [B, R+ss]
        program)."""
        pad_feats, pad_valid = self.flush_inputs(state)
        return self.process_chunk(state, pad_feats, pad_valid, ivector)

    def _flush_impl(self, state, ivector=None):
        """`flush` through the eager body on any device."""
        pad_feats, pad_valid = self.flush_inputs(state)
        return self._process_chunk_impl(state, pad_feats, pad_valid, ivector)


def _check_like(name, x, like, dtype=True) -> None:
    """x must be a tensor of like's shape on like's device (and dtype)."""
    if not isinstance(x, torch.Tensor) or (x.shape, x.device) != (like.shape, like.device) or (
            dtype and x.dtype != like.dtype):
        raise ValueError(f"{name}: got {getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))} on {getattr(x, 'device', None)}; "
                         f"the chunk needs {like.dtype if dtype else 'any dtype'} "
                         f"{tuple(like.shape)} on {like.device}")


class _AmChunkProgram:
    """The captured AM chunk of one shape: the counterpart of the source's
    `jax.jit(self._process_chunk_impl)`, whose cache is also keyed by shape.

    Static inputs: the state {hist [B, H, D] f32, hist_len, feats_seen,
    out_emitted [B] int32}, the f32 features [B, F, D], valid [B, F] and,
    where the key has an i-vector dim I, the f32 i-vector [B, I]; the graph
    of `_process_chunk_impl` over them, whose static outputs are the new
    state, out and out_valid.  Features and i-vector are copied in from any
    dtype and strides (`flush_inputs` gives a stride-0 view), as the body
    reads them through `.to(float32)`.  Before the capture the body runs
    once, eagerly, on the capturing stream: that makes its cuBLAS handle
    and workspace for that stream outside the capture.  `done` is recorded
    after each call's copy-out; the next call's stream waits on it, so a
    caller on another stream cannot race the static buffers."""

    def __init__(self, key):
        dev, B, F, D, H, I = key
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = {"hist": torch.empty((B, H, D), dtype=torch.float32, device=dev),
                      **{k: torch.empty((B,), **i32) for k in STATE_KEYS[1:]}}
        self.feats = torch.empty((B, F, D), dtype=torch.float32, device=dev)
        self.valid = torch.empty((B, F), dtype=torch.bool, device=dev)
        self.ivector = None if I is None else torch.empty((B, I), dtype=torch.float32,
                                                          device=dev)
        self.graph = self.outs = None
        self.done = torch.cuda.Event()

    def _run(self, am):
        return am._process_chunk_impl(self.state, self.feats, self.valid, self.ivector)

    def load(self, state, feats, valid, ivector, stream) -> None:
        """Copy a call's inputs into the static ones, on `stream`, after the
        last call's copy-out."""
        for k, v in self.state.items():
            _check_like(f"state[{k}]", state[k], v)
        _check_like("feats", feats, self.feats, dtype=False)
        _check_like("valid", valid, self.valid)
        if ivector is not None:
            _check_like("ivector", ivector, self.ivector, dtype=False)
        stream.wait_event(self.done)
        for k, v in self.state.items():
            v.copy_(state[k])
        self.feats.copy_(feats)
        self.valid.copy_(valid)
        if ivector is not None:
            self.ivector.copy_(ivector)

    def capture(self, am, side, stream) -> None:
        """The warm-up, then the capture, on the side stream after the
        copy-in (the replay that follows fences `stream` behind them)."""
        side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self._run(am)
            # other threads' CUDA calls stay legal while this one captures
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = self._run(am)
            finally:
                graph.capture_end()
        self.graph, self.outs = graph, outs
        GRAPH_COUNTS["captures"] += 1

    def replay(self, side, stream) -> None:
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.graph.replay()
        stream.wait_stream(side)
        GRAPH_COUNTS["replays"] += 1

    def unload(self, stream):
        """process_chunk's result, copied out of the static outputs into
        fresh tensors on `stream`."""
        state, out, out_valid = self.outs
        res = ({k: v.clone() for k, v in state.items()}, out.clone(), out_valid.clone())
        self.done.record(stream)
        return res
