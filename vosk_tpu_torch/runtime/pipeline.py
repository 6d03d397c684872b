"""Fused streaming pipeline: features -> TDNN-F -> token passing over the
channel batch, with every streaming state on the model's device.

Port of `vosk_tpu/runtime/pipeline.py` `FusedPipeline` (`init_state`,
`step`, `run_scan` with its `ll_bias` hook, `run_adaptive`), the
batch-throughput surface that bench.py times.  The source's `lax.scan` over
chunks becomes a Python loop that writes each chunk's decoder records into
preallocated buffers: `[n_chunks, T, B, K|R]` for the v4 step, the source's
`[n_chunks, B, T, L, K|R]` for v3.  `frame_step` follows the source's rule:
"auto" and "v4" decode the prepared graph (the model's shared decoder: v4
where it is eps-free, else v3; "v4" raises if it is not), "v3" decodes the
raw graph with a decoder of its own (padded rows, or the CSR step where they
would pass PADDED_MAX_SLOTS).  Lattice records are always on.

`run_adaptive` runs `run_scan` in segments, each at the smallest rung of
`adaptive_ladder` (decoders from `BatchViterbi.clone_with_max_active`,
cached on the pipeline, sharing the graph tables) that the live token count
leaves headroom in; the padded layout only, as in the source.

With `mesh` (parallel/mesh.py, one process per rank; source :71-100), a
rank runs the channels of its data coordinate: B must divide by the mesh's
data size, `init_state` holds B / n_data channels, and `step`, `run_scan`
and `run_adaptive` take the global audio ([B, chunk] and [n_chunks, B,
chunk]) and return the rank's channels (`mesh.gather_channels` assembles the
global result); `run_adaptive` picks each rung from the global batch's live
count, as the source reads its global array.  Over a model axis of more
than one rank the native TDNN-F runs tensor parallel, each rank holding its
shard of the parameters (`mesh.am_param_sharding`; models/tdnnf.py
`TensorParallelOps`); an nnet3 AM runs whole on each rank's channels, as the
source leaves it (`Nnet3Am.params` is empty there, so `shard_am_params`
shards nothing).  Decoder tables are each rank's own copy, and decoding
stays channel-local through `decode_chunk`, as in the source.

Not ported, by decision: the ragged unroll (ROADMAP A, "Not ported").  On
the card each chunk's v4 decode replays its captured CUDA graph
(`BatchViterbi.decode_chunk`, ops/viterbi.py), a rung's clone its own,
and so does the AM's chunk (`StreamingAm.process_chunk`,
models/streaming.py) unless the TDNN-F is tensor parallel; the features
still run op by op (ROADMAP B4).
"""
from __future__ import annotations

import torch

from ..io.native import NativeModel
from ..parallel import mesh as pmesh

# run_adaptive takes the smallest rung k with live <= ADAPTIVE_HEADROOM * k
# (the source's default, the only value its callers use)
ADAPTIVE_HEADROOM = 0.75


class FusedPipeline:
    def __init__(
        self,
        model: NativeModel,
        batch: int,
        chunk_seconds: float = 0.2,
        collect_records: bool = True,
        frame_step: str = "auto",
        mesh=None,
    ):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.device = model.device
        self.B = batch
        self.mesh = mesh
        # the rank's channels of the global batch (all of it without a mesh)
        self.channels = slice(0, batch) if mesh is None else pmesh.channel_slice(mesh, batch)
        self.local_B = self.channels.stop - self.channels.start
        self.ex = model.feature_extractor()
        if mesh is not None and pmesh.axis_size(mesh, "model") > 1 \
                and model.am_override is None:
            from ..models.tdnnf import TdnnfModel

            self.am = TdnnfModel(model.am_config, model.am_params, device=self.device, mesh=mesh)
        else:
            self.am = model.make_batch_am()
        if frame_step == "v3":
            self.dec = model.make_decoder(optimize_graph=False, frame_step="v3")
        else:
            self.dec = model.shared_decoder()
            if frame_step == "v4" and self.dec.frame_step != "v4":
                raise ValueError("frame_step='v4' needs a graph that prepare_graph_v4 "
                                 "leaves eps-free")
        self.rate = model.config.sample_rate
        self.chunk_samples = int(chunk_seconds * self.rate)
        self.F = self.ex.stream_max_frames(self.chunk_samples)
        # decoded frames per chunk: the AM's output slots for F features
        self.T = self.am.stream_max_out(self.F)
        self.collect_records = collect_records
        # adaptive max-active ladder (run_adaptive); ascending, capped by the
        # model's max_active
        self.adaptive_ladder = (1024, 2048, 4096)
        self._adaptive_decs = None

    def init_state(self) -> dict:
        """The streaming state of the rank's channels (every channel without
        a mesh)."""
        B = self.local_B
        return {
            "feat": self.ex.init_stream_state(B, self.chunk_samples),
            "am": self.am.init_stream_state(B, self.F),
            "frontier": self.dec.init_frontier(B),
        }

    def _as_device(self, x, dtype, channel_dim=None):
        """x on the device; with channel_dim, only the rank's channels."""
        x = torch.as_tensor(x, dtype=dtype)
        if channel_dim is not None and self.mesh is not None:
            x = x[(slice(None),) * channel_dim + (self.channels,)]
        return x.to(self.device)

    def _step_impl(self, state, audio, n_samples, ll_bias=None, out=None, dec=None):
        feat_state, feats, fvalid = self.ex.extract_chunk(
            state["feat"], audio, n_samples=n_samples
        )
        am_state, ll, lvalid = self.am.process_chunk(state["am"], feats, fvalid)
        if ll_bias is not None:
            # benchmark hook: structured acoustic scores added to the AM
            # output so the decoder sees plausible-path dynamics
            ll = ll * 1e-3 + ll_bias
        frontier, recs, best, bestf = (dec or self.dec).decode_chunk(
            state["frontier"], ll, lvalid, out=out
        )
        new_state = {"feat": feat_state, "am": am_state, "frontier": frontier}
        return new_state, recs, best, bestf, lvalid.sum(dim=1)

    def step(self, state, audio, n_samples=None):
        """audio: [B, chunk_samples], every channel.  Returns (state,
        records|None, best, best_final, frames_decoded [B]) of the rank's
        channels, all on the device."""
        if n_samples is None:
            n_samples = torch.full(audio.shape[:1], audio.shape[1], dtype=torch.int32)
        audio = self._as_device(audio, torch.float32, 0)
        state, recs, best, bestf, frames = self._step_impl(
            state, audio, self._as_device(n_samples, torch.int32, 0))
        return state, recs if self.collect_records else None, best, bestf, frames

    def run_scan(self, state, audio, n_samples=None, ll_bias=None):
        """Advance many chunks back to back.

        audio: [n_chunks, B, chunk_samples] pre-staged chunks of every
        channel.  ll_bias: optional [n_chunks, B, T, P] acoustic bias (see
        `_step_impl`).  Returns, for the rank's channels (every channel
        without a mesh; Bl of them), (state, records {name: [n_chunks, T,
        Bl, K|R]} (v4) or {name: [n_chunks, Bl, T, L, K|R]} (v3), or None
        when collect_records is off; best [n_chunks, Bl])."""
        return self._run_scan_for(self.dec, state, audio, n_samples, ll_bias)

    def _run_scan_for(self, dec, state, audio, n_samples=None, ll_bias=None):
        """`run_scan` through decoder `dec` (this pipeline's, or a clone of
        it at another max_active): its records are sized by dec's K and R."""
        if n_samples is None:
            n_samples = torch.full(audio.shape[:2], audio.shape[2], dtype=torch.int32)
        audio = self._as_device(audio, torch.float32, 1)
        n_chunks = audio.shape[0]
        n_samples = self._as_device(n_samples, torch.int32, 1)
        if ll_bias is not None:
            ll_bias = self._as_device(ll_bias, torch.float32, 1)
        B = self.local_B
        # one chunk's worth of scratch when records are not kept
        recs = dec.record_buffers(
            (n_chunks if self.collect_records else 1, *dec.record_lead(self.T, B)))
        best = torch.empty((n_chunks, B), dtype=torch.float32, device=self.device)
        for i in range(n_chunks):
            j = i if self.collect_records else 0
            state, _, best[i], _, _ = self._step_impl(
                state, audio[i], n_samples[i],
                None if ll_bias is None else ll_bias[i],
                out={k: v[j] for k, v in recs.items()}, dec=dec,
            )
        return state, recs if self.collect_records else None, best

    # ---------------------------------------------------- adaptive max-active

    def _live_max(self, frontier) -> int:
        """The most live tokens in any channel of the global batch: the
        rank's own channels, then a MAX all-reduce over the data axis."""
        live = int(self.dec.live_tokens(frontier).max(initial=0))
        if self.mesh is None or pmesh.axis_size(self.mesh, "data") == 1:
            return live
        x = torch.tensor([live], dtype=torch.int64, device=self.device)
        return int(pmesh.all_reduce_max(self.mesh, "data", x).item())

    def run_adaptive(self, state, audio, n_samples=None, ll_bias=None, seg: int = 4):
        """run_scan in segments of `seg` chunks with an adaptive max_active
        ladder (source :184-233).

        max_active is an upper bound on live tokens (Kaldi semantics): where
        beam pruning keeps fewer tokens live, a decoder at a smaller
        max_active decodes identically.  Before each segment the frontier
        moves (`resize_frontier`) to the smallest rung k of `adaptive_ladder`
        (those below the model's max_active, then the model's own) with live
        <= ADAPTIVE_HEADROOM * k, read from the incoming frontier for the first
        segment and from each segment's last frontier after it; a segment
        that fills a small rung steps up at the next boundary.  Under a mesh
        the live count is the global batch's.

        Returns (state, [records of each segment, or None], best [n_chunks,
        Bl] on the device); a segment's records are run_scan's, at its
        rung's K and R."""
        if self._adaptive_decs is None:
            ladder = [k for k in self.adaptive_ladder if k < self.dec.params.max_active]
            self._adaptive_decs = [self.dec.clone_with_max_active(k) for k in ladder] + [
                self.dec]
        decs = self._adaptive_decs

        def rung(live):
            return next((i for i, d in enumerate(decs) if live <= ADAPTIVE_HEADROOM * d.K),
                        len(decs) - 1)

        T = audio.shape[0]
        if n_samples is None:
            n_samples = torch.full(audio.shape[:2], audio.shape[2], dtype=torch.int32)
        # the first rung from the incoming frontier: a fresh utterance starts
        # small, a carried frontier is not cut to the lowest rung
        cur = rung(self._live_max(state["frontier"]))
        recs_out, best_out = [], []
        for t0 in range(0, T, seg):
            t1 = min(t0 + seg, T)
            dec = decs[cur]
            state = {**state, "frontier": self.dec.resize_frontier(state["frontier"], dec.K)}
            state, recs, best = self._run_scan_for(
                dec, state, audio[t0:t1], n_samples[t0:t1],
                None if ll_bias is None else ll_bias[t0:t1])
            recs_out.append(recs)
            best_out.append(best)
            cur = rung(self._live_max(state["frontier"]))
        return state, recs_out, torch.cat(best_out, dim=0)
