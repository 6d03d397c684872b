"""Synthetic benchmark model at realistic scale: flagship-size TDNN-F AM and
a procedurally generated decoding graph with controllable state/arc counts.

Seed-identical numpy copy of `make_realistic_graph`,
`make_plausible_loglikes` and the realistic branch of `make_bench_model`
from `vosk_tpu/utils/benchdata.py`, so both packages build the same model
and the same scores from a seed (tests/test_torch_copies.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graph.fst import DecodingGraph, SymbolTable
from ..io import native
from ..models.tdnnf import TdnnfConfig, init_params


def make_realistic_graph(
    num_states: int = 2_000_000,
    num_pdfs: int = 6008,
    num_words: int = 100_000,
    max_em_out: int = 8,
    eps_fraction: float = 0.05,
    seed: int = 0,
) -> DecodingGraph:
    """Synthetic HCLG with a realistic shape at honest benchmark scale.

    Mirrors the structure of a Kaldi chain-model HCLG (the reference decodes
    `graph/HCLG.fst`, src/model.cc:278-286):
      * out-degree mix: most states are HMM chain states with a self-loop +
        1-2 forward arcs; a minority are branch points (4-8 arcs); high-fanout
        word/LM hubs are pre-split to `max_em_out` the same way
        graph.optimize.split_high_degree caps real loaded graphs.
      * ~35% of arcs are self-loops (chain topology self-loops).
      * sparse word olabels on ~8% of arcs, vocab `num_words`.
      * `eps_fraction` of states carry 1-2 epsilon (backoff-like) arcs,
        closure depth <= 2.
      * locality: most forward arcs target nearby state ids (BFS-like
        numbering of real graphs), with ~10% long-range (word-exit) jumps.
    Built directly as CSR arrays; a 2M-state graph builds in seconds.
    """
    rng = np.random.default_rng(seed)
    S = num_states
    # out-degree distribution over states
    r = rng.random(S)
    em_cnt = np.full(S, 2, np.int64)          # self-loop + 1 forward
    em_cnt[r < 0.25] = 3                      # + branch
    em_cnt[r < 0.08] = min(6, max_em_out)     # branch points
    em_cnt[r < 0.015] = max_em_out            # pre-split hubs
    em_off = np.zeros(S + 1, np.int32)
    em_off[1:] = np.cumsum(em_cnt)
    Ae = int(em_off[-1])
    state_of_arc = np.repeat(np.arange(S, dtype=np.int64), em_cnt)
    pos_in_state = np.arange(Ae, dtype=np.int64) - em_off[:-1].astype(np.int64)[state_of_arc]

    # targets: slot 0 = self-loop; others nearby jumps, ~10% long-range
    delta = rng.integers(1, 2000, Ae)
    far = rng.random(Ae) < 0.10
    tgt = np.where(far, rng.integers(0, S, Ae), (state_of_arc + delta) % S)
    em_next = np.where(pos_in_state == 0, state_of_arc, tgt).astype(np.int32)

    em_pdf = rng.integers(0, num_pdfs, Ae).astype(np.int32)
    em_olabel = np.where(
        rng.random(Ae) < 0.08, rng.integers(1, num_words + 1, Ae), 0
    ).astype(np.int32)
    # cost structure of a real HCLG: HMM-transition arcs are near-free
    # (competing hypotheses stay inside the beam for many frames — this is
    # what makes real decoders carry hundreds-to-thousands of live tokens);
    # word-emitting arcs carry LM costs of a few nats
    em_w = rng.uniform(0.0, 0.3, Ae).astype(np.float32)
    em_w = np.where(
        em_olabel > 0, rng.uniform(2.0, 10.0, Ae).astype(np.float32), em_w
    )

    n_eps_states = int(S * eps_fraction)
    eps_cnt = np.zeros(S, np.int64)
    eps_states = rng.choice(S, n_eps_states, replace=False)
    eps_cnt[eps_states] = rng.integers(1, 3, n_eps_states)
    eps_off = np.zeros(S + 1, np.int32)
    eps_off[1:] = np.cumsum(eps_cnt)
    An = int(eps_off[-1])
    eps_next = rng.integers(0, S, An).astype(np.int32)
    eps_w = rng.uniform(0.5, 3.0, An).astype(np.float32)
    eps_olabel = np.zeros(An, np.int32)

    final_cost = np.full(S, np.inf, np.float32)
    finals = rng.choice(S, max(S // 50, 1), replace=False)
    final_cost[finals] = rng.uniform(0, 2.0, len(finals)).astype(np.float32)

    return DecodingGraph(
        num_states=S,
        start=0,
        em_off=em_off,
        em_pdf=em_pdf,
        em_olabel=em_olabel,
        em_w=em_w,
        em_next=em_next,
        eps_off=eps_off,
        eps_olabel=eps_olabel,
        eps_w=eps_w,
        eps_next=eps_next,
        final_cost=final_cost,
        eps_depth=2 if An else 0,
        max_em_out=int(em_cnt.max()),
        max_eps_out=int(eps_cnt.max()) if An else 0,
    )


def make_plausible_loglikes(
    graph: DecodingGraph,
    num_pdfs: int,
    batch: int,
    num_frames: int,
    snr: float = 4.0,
    seed: int = 0,
) -> np.ndarray:
    """Acoustic scores shaped like real decoding: per channel, walk a random
    path through the graph and boost the pdfs along it, plus noise.  Random
    (pathless) scores make every graph state equally plausible, which turns
    beam search into worst-case full-graph exploration; real audio locks the
    beam onto path neighborhoods.  Returns [num_frames, batch, num_pdfs]."""
    rng = np.random.default_rng(seed + 1)
    ll = rng.standard_normal((num_frames, batch, num_pdfs)).astype(np.float32)
    off = graph.em_off
    for b in range(batch):
        s = graph.start
        for t in range(num_frames):
            lo, hi = int(off[s]), int(off[s + 1])
            if hi <= lo:
                s = graph.start
                lo, hi = int(off[s]), int(off[s + 1])
                if hi <= lo:
                    break
            ai = int(rng.integers(lo, hi))
            ll[t, b, graph.em_pdf[ai]] += snr
            s = int(graph.em_next[ai])
    return ll


def bench_am_config(num_pdfs: int = 6008, hidden: int = 512,
                    compute_dtype: str = "bfloat16", feat_dim: int = 40) -> TdnnfConfig:
    """The bench TDNN-F (bench.py:213-217): 40/512/96/192/6008, 11 layers,
    strides (1,1,1,0,3,3,3,3,3,3,3), subsample 3, bf16 products."""
    return TdnnfConfig(
        feat_dim=feat_dim,
        hidden_dim=hidden,
        bottleneck_dim=96,
        prefinal_dim=192,
        num_pdfs=num_pdfs,
        time_strides=(1, 1, 1, 0, 3, 3, 3, 3, 3, 3, 3),
        subsample=3,
        compute_dtype=compute_dtype,
    )


def make_bench_model(
    num_states: int = 2_000_000,
    num_pdfs: int = 6008,
    hidden: int = 512,
    max_active: int = 7000,
    beam: float = 13.0,
    compute_dtype: str = "bfloat16",
    seed: int = 0,
    num_words: int = 100_000,
    device="cuda",
    feat_dim: int = 40,
) -> native.NativeModel:
    """In-memory NativeModel on `make_realistic_graph` (the source's
    realistic=True branch).  Defaults are the full width that bench.py
    runs, at the reference operating point (max_active=7000, beam=13,
    lattice_beam=6; src/model.cc:134-147).  `feat_dim` is the AM's input:
    40 MFCC-hires, or 43 with the 3 pitch dims (the model then needs
    `config.pitch_opts`, as a Kaldi dir's pitch.conf gives it)."""
    am_cfg = bench_am_config(num_pdfs, hidden, compute_dtype, feat_dim)
    params = init_params(am_cfg, seed=seed)
    graph = make_realistic_graph(
        num_states=num_states, num_pdfs=num_pdfs, num_words=num_words, seed=seed,
    )
    config = native.ModelConfig(
        sample_rate=16000.0,
        feature_type="mfcc",
        frame_opts={"dither": 0.0},
        mel_opts={"num_bins": 40, "low_freq": 20.0, "high_freq": -400.0},
        mfcc_opts={"num_ceps": 40, "use_energy": False},
        am=dataclasses.asdict(am_cfg),
        beam=beam,
        max_active=max_active,
    )
    words = SymbolTable(["<eps>"] + [f"w{i}" for i in range(1, num_words + 1)])
    phones = SymbolTable(["<eps>", "SIL"])
    return native.NativeModel(
        config=config,
        am_params=params,
        graph=graph,
        words=words,
        phones=phones,
        phone_of_pdf=np.zeros(num_pdfs, np.int32),
        silence_pdfs=np.array([0], np.int32),
        device=device,
    )
