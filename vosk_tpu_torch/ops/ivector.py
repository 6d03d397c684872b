"""Online i-vector extraction as batched matrix products, in PyTorch.

Port of `vosk_tpu/ops/ivector.py` `OnlineIvectorExtractor` (the role of
Kaldi's `OnlineIvectorFeature`, used when a model ships an `ivector/` dir,
reference src/model.cc:247-263): per frame, splice+LDA the MFCCs, pick the
top `num_gselect` diagonal-UBM Gaussians on the CMVN'd stream, turn their
log-likelihoods into pruned posteriors, accumulate zeroth/first-order stats
on the non-CMVN'd stream, and solve the i-vector posterior mean

    (I + sum_g gamma_g M_g^T Sigma_g^{-1} M_g) x
        = prior_offset * e0 + sum_g M_g^T Sigma_g^{-1} x_g

Every tensor of the state lives on the extractor's device; nothing here
reads the host.  Against the source:
  * the Gaussian selection is a stable descending sort, so ties go to the
    lower index as `jax.lax.top_k` gives them;
  * the one-hot einsums over [B, O, Q, G] are `scatter_add_` on the
    Gaussian axis (the same sums);
  * the ring writes are in-place row writes on the state's tensors;
  * `reweight` writes each slot once (see its docstring);
  * the solve is `torch.linalg.solve_ex` on the batched [B, I, I] system,
    f32, with no singularity check (that check would read the host).
The source's deviations from Kaldi are inherited as they are: the online
CMVN of the posterior stream subtracts the global mean only (Kaldi
interpolates utterance statistics with the global prior), and frames older
than the reweight ring keep their original weight.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.kaldi_ivector import IvectorDirConfig


@dataclasses.dataclass
class _Tables:
    lda_t: torch.Tensor       # [Ds, Do]  (LDA transposed)
    lda_offset: torch.Tensor  # [Do]
    miv_t: torch.Tensor       # [D, G]    (means * invvars)^T
    ivars_t: torch.Tensor     # [D, G]
    gconsts: torch.Tensor     # [G]
    proj: torch.Tensor        # [G*D, I]  M_g^T Sigma_g^{-1}, flattened
    U: torch.Tensor           # [G, I*I]  M_g^T Sigma_g^{-1} M_g, flattened
    cmvn_mean: torch.Tensor   # [Din]


class OnlineIvectorExtractor:
    """Streaming i-vector extractor over B channels.

    A frame's stats are accumulated once it has `splice_right` frames of
    real right context (`flush()` emits the tail with edge-copy context).
    Recent frames' contributions live in a ring so silence weighting can
    retroactively reweight them by absolute frame index.
    """

    def __init__(self, cfg: IvectorDirConfig, chunk_frames: int = 32,
                 ring: int = 64, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        g = cfg.dubm
        ie = cfg.extractor
        self.G, self.D = g.num_gauss, ie.feat_dim
        self.I = ie.ivector_dim
        self.Q = min(cfg.num_gselect, self.G)
        self.ring = ring
        self.splice_l, self.splice_r = cfg.splice_left, cfg.splice_right
        self.T = chunk_frames

        lda = cfg.lda.astype(np.float32)
        Din = cfg.global_cmvn.shape[1] - 1
        self.Din = Din
        spliced = Din * (self.splice_l + self.splice_r + 1)
        if lda.shape[1] == spliced + 1:
            lda_m, lda_off = lda[:, :-1], lda[:, -1]
        else:
            lda_m, lda_off = lda, np.zeros(lda.shape[0], np.float32)

        stats = cfg.global_cmvn
        count = max(float(stats[0, -1]), 1.0)
        mean = (stats[0, :-1] / count).astype(np.float32)

        proj = np.einsum("gdi,gde->gie", ie.M, ie.sigma_inv).astype(np.float32)
        U = np.einsum("gie,gej->gij", proj, ie.M).astype(np.float32)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)

        G, D, I = self.G, self.D, self.I
        self.t = _Tables(
            lda_t=t(lda_m.T),
            lda_offset=t(lda_off),
            miv_t=t(g.means_invvars.T),
            ivars_t=t(g.inv_vars.T),
            gconsts=t(g.gconsts),
            proj=t(proj.transpose(0, 2, 1).reshape(G * D, I)),
            U=t(U.reshape(G, I * I)),
            cmvn_mean=t(mean),
        )
        self.prior_offset = float(ie.prior_offset)

    # ------------------------------------------------------------- state

    def init_state(self, batch: int) -> dict:
        ctx = self.splice_l + self.splice_r
        H = ctx + self.T + 4
        dev = self.device

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "gamma": z(batch, self.G),
            "xstat": z(batch, self.G, self.D),
            "hist": z(batch, H, self.Din),
            "hist_len": z(batch, dtype=torch.int32),
            "feats_seen": z(batch, dtype=torch.int32),
            "centers_done": z(batch, dtype=torch.int32),
            "ring_idx": z(batch, self.ring, self.Q, dtype=torch.int64),
            "ring_post": z(batch, self.ring, self.Q),
            "ring_y": z(batch, self.ring, self.D),
            "ring_w": torch.ones((batch, self.ring), dtype=torch.float32, device=dev),
            "ring_pos": z(batch, dtype=torch.int32),
        }

    # ----------------------------------------------------------- pipeline

    def _splice_lda(self, frames, cmvn: bool):
        """frames: [B, T+l+r, Din] -> [B, T, D]."""
        l, r = self.splice_l, self.splice_r
        if cmvn:
            frames = frames - self.t.cmvn_mean
        T = frames.shape[1] - l - r
        spliced = torch.cat([frames[:, i: i + T] for i in range(l + r + 1)], dim=2)
        return spliced @ self.t.lda_t + self.t.lda_offset

    def _gauss_stats(self, post, idx, y):
        """Per-Gaussian sums of post [B, N, Q] at idx [B, N, Q]: the
        occupancy [B, N, G] scattered per frame (a frame's Q indices are
        distinct), its frame sum [B, G] and first-order stats with y
        [B, N, D] -> [B, G, D]."""
        B, N, _ = post.shape
        pg = torch.zeros((B, N, self.G), dtype=post.dtype, device=post.device)
        pg.scatter_add_(2, idx, post)
        return pg.sum(dim=1), pg.transpose(1, 2) @ y

    def update(self, state, feats, valid=None, flush=False):
        """Append one chunk and accumulate stats for every center frame that
        now has full right context (all of them, edge-copied, if flush).

        feats: [B, T, Din] raw MFCC frames; valid: [B, T] bool (prefix).
        """
        B, T, Din = feats.shape
        dev = feats.device
        if valid is None:
            valid = torch.ones((B, T), dtype=torch.bool, device=dev)
        l, r = self.splice_l, self.splice_r
        hist, hist_len = state["hist"], state["hist_len"]
        H = hist.shape[1]
        O = T + (r if flush else 0)  # max centers emitted this call

        def take_rows(x, idx):  # x [B, L, D], idx [B, M] -> [B, M, D]
            return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[2]))

        # ---- shift-append valid frames into hist (StreamingAm pattern)
        n_new = valid.sum(dim=1).to(torch.int32)
        col = torch.arange(H, dtype=torch.int32, device=dev)[None, :]
        overflow = torch.clamp(hist_len + n_new - H, min=0)
        src = torch.clamp(col + overflow[:, None], 0, H - 1)
        hist = take_rows(hist, src)
        hist_len2 = hist_len - overflow
        fsrc = torch.clamp(col - hist_len2[:, None], 0, T - 1)
        newf = take_rows(feats.to(torch.float32), fsrc)
        write = (col >= hist_len2[:, None]) & (col < (hist_len2 + n_new)[:, None])
        hist = torch.where(write[:, :, None], newf, hist)
        hist_len3 = hist_len2 + n_new
        feats_seen = state["feats_seen"] + n_new
        done = state["centers_done"]

        # centers ready: full right context (or everything seen, if flush)
        total_ready = feats_seen if flush else torch.clamp(feats_seen - r, min=0)
        n_emit = torch.clamp(total_ready - done, 0, O)

        # ---- window: centers done..done+O-1 with l left / r right context,
        # clamped to the stream edges (edge replication)
        W = O + l + r
        hist_base = feats_seen - hist_len3
        wcol = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        abs_pos = torch.minimum(
            torch.clamp((done - l)[:, None] + wcol, min=0),
            torch.clamp(feats_seen - 1, min=0)[:, None],
        )
        widx = torch.clamp(abs_pos - hist_base[:, None], 0, H - 1)
        window = take_rows(hist, widx)

        y = self._splice_lda(window, cmvn=False)   # [B, O, D] stats stream
        yc = self._splice_lda(window, cmvn=True)   # [B, O, D] posterior stream

        ll = yc @ self.t.miv_t - 0.5 * (yc * yc) @ self.t.ivars_t + self.t.gconsts
        order = torch.sort(ll, dim=-1, descending=True, stable=True)
        top, idx = order.values[..., : self.Q], order.indices[..., : self.Q]
        post = torch.softmax(top, dim=-1)
        post = torch.where(post >= self.cfg.min_post, post, 0.0)
        post = post / torch.clamp(post.sum(dim=-1, keepdim=True), min=1e-9)
        tcol = torch.arange(O, dtype=torch.int32, device=dev)[None, :]
        emask = tcol < n_emit[:, None]
        post = post * (emask.to(torch.float32) * self.cfg.posterior_scale)[:, :, None]

        dgamma, dx = self._gauss_stats(post, idx, y)
        gamma = state["gamma"] + dgamma
        xstat = state["xstat"] + dx

        # ---- ring of per-center contributions (absolute center index
        # done+j lands in slot (ring_pos+j) % ring), written in place
        pos = state["ring_pos"]
        slot = ((pos[:, None] + tcol) % self.ring).long()
        bcol = torch.arange(B, device=dev)[:, None].expand(B, O)
        sel = emask[:, :, None]
        ring_idx, ring_post = state["ring_idx"], state["ring_post"]
        ring_y, ring_w = state["ring_y"], state["ring_w"]
        ring_idx[bcol, slot] = torch.where(sel, idx, ring_idx[bcol, slot])
        ring_post[bcol, slot] = torch.where(sel, post, ring_post[bcol, slot])
        ring_y[bcol, slot] = torch.where(sel, y, ring_y[bcol, slot])
        ring_w[bcol, slot] = torch.where(emask, 1.0, ring_w[bcol, slot])

        return {
            "gamma": gamma,
            "xstat": xstat,
            "hist": hist,
            "hist_len": hist_len3,
            "feats_seen": feats_seen,
            "centers_done": done + n_emit,
            "ring_idx": ring_idx,
            "ring_post": ring_post,
            "ring_y": ring_y,
            "ring_w": ring_w,
            "ring_pos": (pos + n_emit) % self.ring,
        }

    def reweight(self, state, frame_ids, new_weights):
        """Retroactively change weights of recent frames (silence weighting).

        frame_ids: [B, N] absolute frame indices (-1 = ignore);
        new_weights: [B, N] (tensors, or arrays moved to the device).
        Frames older than the ring keep their original weight
        (bounded-memory approximation).  Each ring slot an accepted frame
        maps to is written once; ignored entries write nothing (the source
        writes their slot 0 back with its old value, which can undo an
        accepted frame's ring update in slot 0 depending on scatter order;
        the statistics are the same either way)."""
        dev = state["gamma"].device
        frame_ids = torch.as_tensor(frame_ids, device=dev).to(torch.int32)
        new_weights = torch.as_tensor(new_weights, device=dev).to(torch.float32)
        B, N = frame_ids.shape
        ring = self.ring
        done = state["centers_done"]
        age = done[:, None] - 1 - frame_ids  # 0 = newest accumulated
        ok = (frame_ids >= 0) & (age >= 0) & (age < torch.clamp(done[:, None], max=ring))
        slot = torch.where(ok, (state["ring_pos"][:, None] - 1 - age) % ring, 0).long()
        bcol = torch.arange(B, device=dev)[:, None].expand(B, N)
        old_w = state["ring_w"][bcol, slot]
        ratio = torch.where(
            ok & (old_w > 1e-9), new_weights / torch.clamp(old_w, min=1e-9), 1.0
        )
        post = state["ring_post"][bcol, slot]  # [B, N, Q]
        dpost = post * (ratio[:, :, None] - 1.0)
        dgamma, dx = self._gauss_stats(dpost, state["ring_idx"][bcol, slot],
                                       state["ring_y"][bcol, slot])
        # per-slot ratio and weight; ignored entries go to a spare column
        tgt = torch.where(ok, slot, ring)
        r_slot = torch.ones((B, ring + 1), dtype=torch.float32, device=dev)
        r_slot.scatter_(1, tgt, ratio)
        hit = torch.zeros((B, ring + 1), dtype=torch.bool, device=dev)
        hit.scatter_(1, tgt, True)
        w_slot = torch.zeros((B, ring + 1), dtype=torch.float32, device=dev)
        w_slot.scatter_(1, tgt, new_weights)
        ring_post = state["ring_post"] * r_slot[:, :ring, None]
        ring_w = torch.where(hit[:, :ring], w_slot[:, :ring], state["ring_w"])
        return {**state, "gamma": state["gamma"] + dgamma,
                "xstat": state["xstat"] + dx,
                "ring_post": ring_post, "ring_w": ring_w}

    def _solve(self, gamma, xstat):
        """gamma [B, G], xstat [B, G, D] -> i-vector [B, I], prior-corrected
        (dim 0 has prior_offset subtracted), ready for the AM input."""
        cfg = self.cfg
        B = gamma.shape[0]
        count = gamma.sum(dim=1)
        if cfg.max_count > 0:
            scale = torch.where(count > cfg.max_count,
                                cfg.max_count / torch.clamp(count, min=1e-9), 1.0)
        else:
            scale = torch.ones_like(count)
        gamma = gamma * scale[:, None]
        xstat = xstat * scale[:, None, None]
        quad = (gamma @ self.t.U).view(B, self.I, self.I)
        quad = quad + torch.eye(self.I, dtype=torch.float32, device=gamma.device)
        lin = xstat.reshape(B, -1) @ self.t.proj
        e0 = torch.zeros(self.I, dtype=torch.float32, device=gamma.device)
        e0[0] = self.prior_offset
        iv = torch.linalg.solve_ex(quad, (lin + e0)[:, :, None])[0][:, :, 0]
        return iv - e0

    # -------------------------------------------------------------- API

    def flush(self, state):
        """Emit the held-back tail frames (edge-copied right context)."""
        B = state["gamma"].shape[0]
        dev = state["gamma"].device
        feats = torch.zeros((B, 1, self.Din), dtype=torch.float32, device=dev)
        valid = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        return self.update(state, feats, valid, flush=True)

    def current(self, state):
        """Most-recent i-vector estimate [B, I] (the reference's
        use_most_recent_ivector=true online mode)."""
        return self._solve(state["gamma"], state["xstat"])
