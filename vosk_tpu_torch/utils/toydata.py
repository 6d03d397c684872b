"""Synthetic speech world for tests, demos and the recipe: tone-sequence
"words", a trained mini TDNN-F acoustic model, and a compiled decoding graph.

Port of `vosk_tpu/utils/toydata.py`.  The synthesis (the symbols, the
phone and utterance synthesisers, the generated `ToyLanguage`,
`make_test_wav`) is a numpy copy that tests/test_torch_copies.py holds to
its source.  Model building runs on the port: features from its
`FeatureExtractor` (brought to the host), training with its trainers on
`device`, the graph from its `graph/builder.py` and `graph/lm.py`, the
directory from its `io/native.save_model`.  The data preparation the
source repeats in each builder and in the recipe is `aligned_batch` here.

Serves the role of the reference's downloadable test models + test.wav
fixture (python/example/test.wav, a digits recording): fully deterministic,
generated in-process, no downloads.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from ..graph.builder import Lexicon, Topology, build_decoding_graph
from ..graph.fst import SymbolTable
from ..graph.lm import LanguageModelEstimator, LanguageModelOptions
from ..io import native
from ..models.tdnnf import TdnnfConfig
from ..ops import features as F

RATE = 16000
PHONE_DUR = 0.09  # seconds per phone

# 8 tone phones + silence
TONE_FREQS = [330.0, 500.0, 740.0, 1100.0, 1600.0, 2300.0, 3300.0, 4700.0]

WORDS = ["zero", "one", "two", "three", "four", "five", "six", "seven"]
# each word = 2 tone phones, distinct sequences
WORD_PHONES = {
    "zero": [1, 2],
    "one": [3, 4],
    "two": [5, 6],
    "three": [7, 8],
    "four": [2, 1],
    "five": [4, 3],
    "six": [6, 5],
    "seven": [8, 7],
}
SIL_PHONE = 9  # phone id of silence


def build_symbols() -> Tuple[SymbolTable, SymbolTable]:
    words = SymbolTable(["<eps>"] + WORDS)
    phones = SymbolTable(["<eps>"] + [f"t{i}" for i in range(1, 9)] + ["SIL"])
    return words, phones


def synth_phone(phone: int, rng, dur: float = PHONE_DUR) -> np.ndarray:
    n = int(dur * RATE)
    t = np.arange(n) / RATE
    if phone == SIL_PHONE:
        return (60.0 * rng.standard_normal(n)).astype(np.float32)
    f0 = TONE_FREQS[phone - 1]
    sig = 3000.0 * np.sin(2 * np.pi * f0 * t) + 120.0 * rng.standard_normal(n)
    return sig.astype(np.float32)


def synth_utterance(
    word_seq: List[str], rng, sil_between: bool = True
) -> Tuple[np.ndarray, List[int]]:
    """Returns (samples, per-sample phone ids)."""
    sam, phn = [], []
    def emit(ph):
        s = synth_phone(ph, rng)
        sam.append(s)
        phn.extend([ph] * len(s))
    emit(SIL_PHONE)
    for w in word_seq:
        for ph in WORD_PHONES[w]:
            emit(ph)
        if sil_between:
            emit(SIL_PHONE)
    wav = np.concatenate(sam)
    return wav, np.array(phn, np.int32)


@dataclasses.dataclass
class ToyLanguage:
    """A generated toy language at parameterized scale (vocab size, phone
    inventory, homophones) — the corpus generator behind the scaled
    WER-parity tests (the reference's accuracy gate is WER on a real
    few-hundred-thousand-word language, training/RESULTS.txt; this is the
    synthetic stand-in at a few-thousand-graph-state scale)."""

    words: SymbolTable
    phones: SymbolTable
    word_phones: dict  # word name -> phone id list
    tone_freqs: List[float]
    sil_phone: int

    @property
    def n_phones(self) -> int:
        return self.sil_phone  # tone phones are 1..sil_phone-1


def build_big_language(
    n_words: int = 600,
    n_phones: int = 14,
    word_len: Tuple[int, int] = (2, 4),
    homophone_pairs: int = 25,
    seed: int = 0,
) -> ToyLanguage:
    """Generate a vocabulary of `n_words` over `n_phones` tone phones with
    `homophone_pairs` exact homophone pairs (identical pronunciations —
    only the LM can separate them) plus naturally-occurring one-phone-apart
    near-homophones.  Tone frequencies are geometric between 300 and
    4800 Hz, so adjacent phones are acoustically closer than the 8-word
    toy set's — beam competition is real."""
    rng = np.random.default_rng(seed)
    freqs = list(300.0 * (4800.0 / 300.0) ** (np.arange(n_phones) /
                                              max(n_phones - 1, 1)))
    names = [f"w{i:04d}" for i in range(n_words)]
    prons: dict = {}
    seen = set()
    for i, nm in enumerate(names):
        while True:
            L = int(rng.integers(word_len[0], word_len[1] + 1))
            # no immediate repeats (1-state topology can't separate them)
            seq = [int(rng.integers(1, n_phones + 1))]
            while len(seq) < L:
                p = int(rng.integers(1, n_phones + 1))
                if p != seq[-1]:
                    seq.append(p)
            key = tuple(seq)
            if key not in seen:
                seen.add(key)
                prons[nm] = seq
                break
    # designate exact homophone pairs: the second word of each pair copies
    # the first's pronunciation
    pairs = rng.choice(n_words, size=(min(homophone_pairs,
                                          n_words // 2), 2), replace=False)
    for a, b in pairs:
        prons[names[b]] = list(prons[names[a]])
    sil = n_phones + 1
    words = SymbolTable(["<eps>"] + names)
    phones = SymbolTable(
        ["<eps>"] + [f"t{i}" for i in range(1, n_phones + 1)] + ["SIL"]
    )
    return ToyLanguage(words, phones, prons, freqs, sil)


def synth_phone_lang(lang: ToyLanguage, phone: int, rng,
                     dur: float = PHONE_DUR) -> np.ndarray:
    n = int(dur * RATE)
    t = np.arange(n) / RATE
    if phone == lang.sil_phone:
        return (60.0 * rng.standard_normal(n)).astype(np.float32)
    f0 = lang.tone_freqs[phone - 1]
    sig = 3000.0 * np.sin(2 * np.pi * f0 * t) + 120.0 * rng.standard_normal(n)
    return sig.astype(np.float32)


def synth_utterance_lang(
    lang: ToyLanguage, word_seq: List[str], rng, sil_between: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    sam, phn = [], []

    def emit(ph):
        s = synth_phone_lang(lang, ph, rng)
        sam.append(s)
        phn.extend([ph] * len(s))

    emit(lang.sil_phone)
    for w in word_seq:
        for ph in lang.word_phones[w]:
            emit(ph)
        if sil_between:
            emit(lang.sil_phone)
    return np.concatenate(sam), np.array(phn, np.int32)


def aligned_batch(
    extractor, utts: Sequence[Tuple[np.ndarray, np.ndarray]], ss: int = 3
) -> Tuple[np.ndarray, np.ndarray]:
    """(feats [N, Tmax, D] f32, labels [N, ceil(Tmax/ss)] int64) from
    (wav [n], per-sample phone ids [n]) pairs: each output frame's label is
    the phone at its centre sample, minus 1 (pdf = phone - 1, the 1-state
    topology); features and labels are padded with copies of their last
    row.  Features are computed on the extractor's device and brought to
    the host."""
    fo = extractor.frame_opts
    utt_feats, utt_labels = [], []
    for wav, phn in utts:
        feats = extractor.extract(np.asarray(wav)[None])[0].cpu().numpy()  # [T, D]
        n_out = -(-feats.shape[0] // ss)
        centers = (np.arange(n_out) * ss) * fo.window_shift + fo.window_size // 2
        utt_feats.append(feats)
        utt_labels.append(phn[np.clip(centers, 0, len(phn) - 1)] - 1)
    Tmax = max(f.shape[0] for f in utt_feats)
    Omax = -(-Tmax // ss)
    fpad = np.zeros((len(utt_feats), Tmax, utt_feats[0].shape[1]), np.float32)
    lpad = np.zeros((len(utt_feats), Omax), np.int64)
    for i, (f, l) in enumerate(zip(utt_feats, utt_labels)):
        fpad[i, : f.shape[0]] = f
        fpad[i, f.shape[0]:] = f[-1]
        lpad[i, : len(l)] = l
        lpad[i, len(l):] = l[-1]
    return fpad, lpad


def train_am(am_cfg: TdnnfConfig, fpad, lpad, objective: str, steps: int, seed: int,
             device="cuda") -> dict:
    """The AM trained with frame CE (models/train.py) or LF-MMI
    (models/chain.py), as the source's builders and recipe choose."""
    if objective == "chain":
        from ..models.chain import train_chain

        return train_chain(am_cfg, fpad, lpad, steps=steps, seed=seed, device=device)
    from ..models.train import train_frame_ce

    return train_frame_ce(am_cfg, fpad, lpad, steps=steps, seed=seed, device=device)


def build_big_model(
    out_dir,
    lang: ToyLanguage,
    train_steps: int = 500,
    seed: int = 0,
    n_train_utts: int = 30,
    lm_sentences: int = 3000,
    words_per_sentence: int = 5,
    beam: float = 16.0,
    max_active: int = 2000,
    device="cuda",
) -> None:
    """Train an AM on the generated language and save a model dir.

    The AM is phone-level, so a small synthesized training set covers the
    inventory; the LM text corpus is larger (text is free) and cycles the
    whole vocabulary so every word has a unigram in G."""
    rng = np.random.default_rng(seed)
    names = [lang.words.name(i) for i in range(1, len(lang.words))]
    ex = make_extractor(device=device)
    ss = 3
    utts = []
    for _ in range(n_train_utts):
        ws = [names[rng.integers(0, len(names))]
              for _ in range(words_per_sentence)]
        utts.append(synth_utterance_lang(lang, ws, rng))
    fpad, lpad = aligned_batch(ex, utts, ss)
    am_cfg = TdnnfConfig(
        feat_dim=fpad.shape[2], hidden_dim=64, bottleneck_dim=16,
        prefinal_dim=32, num_pdfs=lang.sil_phone,
        time_strides=(1, 1, ss), subsample=ss,
    )
    params = train_am(am_cfg, fpad, lpad, "ce", train_steps, seed, device)

    # LM corpus: RANDOM sentences over the whole vocabulary.  A corpus
    # that chains the vocab deterministically would hand specific word
    # bigrams a huge cost advantage over (universally unseen) test
    # bigrams, and the decoder would ride those chains against the
    # acoustics — an adversarial LM, not a realistic one.  Volume is set
    # so every word's unigram is well-estimated (~25 occurrences); one
    # cycling pass guarantees full-vocab graph coverage regardless of
    # seed.
    est = LanguageModelEstimator(LanguageModelOptions(2, 0.5))
    perm = rng.permutation(len(names))
    for k in range(0, len(names), words_per_sentence):
        ws = [names[j] for j in perm[k: k + words_per_sentence]]
        if ws:
            est.add_counts([lang.words.find(w) for w in ws])
    for _ in range(lm_sentences):
        ws = [names[rng.integers(0, len(names))]
              for _ in range(words_per_sentence)]
        est.add_counts([lang.words.find(w) for w in ws])
    g = est.estimate()

    lex = Lexicon(
        words=lang.words, phones=lang.phones,
        prons={lang.words.find(w): [list(p)]
               for w, p in lang.word_phones.items()},
        silence_phone=lang.sil_phone, silence_cost=0.7,
        label_last=True,  # trie lexicon: no vocab-degree hub states
    )
    topo = Topology(states_per_phone=1, self_loop_prob=0.7)
    graph, info = build_decoding_graph(lex, g, topo)
    config = native.ModelConfig(
        sample_rate=RATE, beam=beam, max_active=max_active,
        acoustic_scale=1.0, am=dataclasses.asdict(am_cfg),
        **_feature_config(),
    )
    native.save_model(
        out_dir, config, params, graph, lang.words, lang.phones,
        info["phone_of_pdf"], info["silence_pdfs"], lexicon=lex, topology=topo, g_fst=g,
    )


def _feature_config() -> dict:
    return dict(
        feature_type="mfcc",
        frame_opts={"dither": 1.0},
        mel_opts={"num_bins": 24, "low_freq": 20.0, "high_freq": -400.0},
        mfcc_opts={"num_ceps": 20, "use_energy": False},
    )


def make_extractor(pitch: bool = False, device="cuda") -> F.FeatureExtractor:
    cfg = _feature_config()
    fo = F.FrameOptions(dither=0.0)  # deterministic features for training
    return F.FeatureExtractor(
        F.MfccOptions(
            frame_opts=fo,
            mel_opts=F.MelOptions(**cfg["mel_opts"]),
            **cfg["mfcc_opts"],
        ),
        pitch_opts={} if pitch else None,
        device=device,
    )


def toy_lexicon(words: SymbolTable, phones: SymbolTable) -> Lexicon:
    """The toy language's lexicon: one pronunciation a word, optional
    silence between words."""
    return Lexicon(
        words=words,
        phones=phones,
        prons={words.find(w): [list(p)] for w, p in WORD_PHONES.items()},
        silence_phone=SIL_PHONE,
        silence_cost=0.7,
    )


def build_toy_model(
    out_dir,
    train_steps: int = 400,
    seed: int = 0,
    hidden: int = 64,
    bottleneck: int = 16,
    strides: Tuple[int, ...] = (1, 1, 3),
    beam: float = 16.0,
    max_active: int = 2000,
    pitch: bool = False,
    objective: str = "ce",  # "ce" | "chain" (LF-MMI, models/chain.py)
    device="cuda",
) -> None:
    """Train the toy AM on synthetic aligned data on `device`, compile the
    graph, save a native model dir.  pitch=True appends the 3 online-pitch
    dims to the features (the reference's conf/pitch.conf models,
    model.cc:265-276) and trains the AM on them.  objective="chain" trains
    with LF-MMI (the reference recipe's objective, training/run.sh stage
    4)."""
    rng = np.random.default_rng(seed)
    words, phones = build_symbols()

    # ----- training data: random word sequences
    ex = make_extractor(pitch=pitch, device=device)
    n_utts, n_words, ss = 24, 5, 3
    sentences, utts = [], []
    for _ in range(n_utts):
        ws = [WORDS[rng.integers(0, len(WORDS))] for _ in range(n_words)]
        sentences.append(ws)
        utts.append(synth_utterance(ws, rng))
    fpad, lpad = aligned_batch(ex, utts, ss)

    am_cfg = TdnnfConfig(
        feat_dim=fpad.shape[2],
        hidden_dim=hidden,
        bottleneck_dim=bottleneck,
        prefinal_dim=32,
        num_pdfs=9,  # 8 tones + SIL (1-state topology)
        time_strides=strides,
        subsample=ss,
    )
    params = train_am(am_cfg, fpad, lpad, objective, train_steps, seed, device)

    # ----- language model: bigram over the training sentences
    est = LanguageModelEstimator(LanguageModelOptions(2, 0.5))
    for ws in sentences:
        est.add_counts([words.find(w) for w in ws])
    g = est.estimate()

    lex = toy_lexicon(words, phones)
    topo = Topology(states_per_phone=1, self_loop_prob=0.7)
    graph, info = build_decoding_graph(lex, g, topo)

    config = native.ModelConfig(
        sample_rate=RATE,
        beam=beam,
        max_active=max_active,
        acoustic_scale=1.0,
        am=dataclasses.asdict(am_cfg),
        pitch_opts={} if pitch else None,
        **_feature_config(),
    )
    native.save_model(
        out_dir, config, params, graph, words, phones,
        info["phone_of_pdf"], info["silence_pdfs"], lexicon=lex, topology=topo, g_fst=g,
    )


def make_test_wav(
    word_seq: List[str], seed: int = 123, sil_between: bool = True
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    wav, _ = synth_utterance(word_seq, rng, sil_between)
    return wav
