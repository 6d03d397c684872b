"""vosk_tpu_torch's training path against vosk_tpu's, on the CPU, at small
sizes: the LF-MMI objective's pieces (denominator graph, forward recursion
with and without the leak, numerator, objective and its gradient), the
trainers (frame CE, chain, RNNLM) step by step, one bf16 step of the
TDNN-F, and the whole-utterance forward.  Inputs come from numpy seeds and
reach both packages as numpy arrays.

The source's trainers return only their parameters, so the source's steps
are driven here by its own loss pieces (`TdnnfModel.forward_utterance`,
`chain_objective`, `RnnlmModel._step_impl`) under `optax.adam`, the loop
its trainers run; each such loop is first held to the trainer itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vosk_tpu.models import chain as j_chain
from vosk_tpu.models import rnnlm as j_rnnlm
from vosk_tpu.models import tdnnf as j_tdnnf
from vosk_tpu.models import train as j_train
from vosk_tpu_torch.models import chain, rnnlm, tdnnf, train

P = 7  # pdfs of the tiny AM


def _cfg(dtype="float32"):
    kw = dict(feat_dim=8, hidden_dim=16, bottleneck_dim=8, prefinal_dim=8, num_pdfs=P,
              time_strides=(1, 0, 3), subsample=3, compute_dtype=dtype)
    return j_tdnnf.TdnnfConfig(**kw), tdnnf.TdnnfConfig(**kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((4, 31, 8)).astype(np.float32)
    labels = rng.integers(0, P, (4, 11)).astype(np.int64)  # ceil(31 / 3) frames
    return feats, labels


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ------------------------------------------------------ the objective's pieces

def test_denominator_graph_equals_source():
    labels = np.random.default_rng(2).integers(0, 9, (24, 40))
    a = j_chain.DenominatorGraph.from_alignments(labels, 9)
    b = chain.DenominatorGraph.from_alignments(labels, 9)
    for k in ("trans", "init", "final"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.leaky_hmm == b.leaky_hmm


def _den_pair(S, B, T, seed, leak):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, S, (B, T))
    dj = j_chain.DenominatorGraph.from_alignments(labels, S)
    dt = chain.DenominatorGraph.from_alignments(labels, S)
    dj.leaky_hmm = dt.leaky_hmm = leak
    ll = (3.0 * rng.standard_normal((B, T, S))).astype(np.float32)
    return dj, dt, ll, labels


@pytest.mark.parametrize("leak", [0.0, 0.1])
def test_den_logprob_matches_source(leak):
    """Within rel 1e-5, the source's own bound against brute force
    (tests/test_chain.py:44)."""
    dj, dt, ll, _ = _den_pair(S=12, B=5, T=20, seed=3, leak=leak)
    want = np.asarray(j_chain.den_logprob(dj, jnp.asarray(ll)))
    got = chain.den_logprob(dt, torch.tensor(ll)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the graph carried to the device gives the same numbers
    got2 = chain.den_logprob(chain.graph_to(dt, "cpu"), torch.tensor(ll)).numpy()
    np.testing.assert_array_equal(got2, got)


@pytest.mark.parametrize("leak", [0.0, 0.1])
def test_num_logprob_objective_and_gradient_match_source(leak):
    dj, dt, ll, labels = _den_pair(S=10, B=4, T=15, seed=4, leak=leak)
    lab_j, lab_t = jnp.asarray(labels), torch.tensor(labels)
    np.testing.assert_allclose(chain.num_logprob(dt, torch.tensor(ll), lab_t).numpy(),
                               np.asarray(j_chain.num_logprob(dj, jnp.asarray(ll), lab_j)),
                               rtol=1e-6)
    (loss_j, aux_j), g_j = jax.value_and_grad(
        lambda x: j_chain.chain_objective(dj, x, lab_j), has_aux=True)(jnp.asarray(ll))
    x = torch.tensor(ll, requires_grad=True)
    loss_t, aux_t = chain.chain_objective(dt, x, lab_t)
    loss_t.backward()
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-6)
    for k in ("mmi", "xent"):
        assert float(aux_t[k].detach()) == pytest.approx(float(aux_j[k]), rel=1e-5, abs=1e-7), k
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-9)


def test_forward_utterance_matches_source(data):
    feats, _ = data
    cj, ct = _cfg()
    params = tdnnf.init_params(ct, seed=5)
    want = np.asarray(j_tdnnf.TdnnfModel(cj, params).forward_utterance(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats)))
    got = tdnnf.TdnnfModel(ct, params, device="cpu").forward_utterance(torch.tensor(feats))
    assert got.shape == want.shape == (4, 11, P)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_serving_forward_unchanged_by_training_mode(data):
    """A trainable bf16 model rounds its f32 weights inside each product; a
    serving one holds them pre-rounded: the two forwards are bit-equal."""
    feats, _ = data
    _, ct = _cfg("bfloat16")
    params = tdnnf.init_params(ct, seed=6)
    x = torch.tensor(feats)
    serve = tdnnf.TdnnfModel(ct, params, device="cpu")(x)
    with torch.no_grad():
        trained = tdnnf.TdnnfModel(ct, params, device="cpu", trainable=True)(x)
    assert torch.equal(serve, trained)


def test_bf16_product_gradient_is_rounded_after_the_product():
    """`jax.grad` of the source's bf16 product (f32 result) returns
    gradients that are bf16 values: the f32 cotangent, not rounded, times
    the other rounded operand, rounded once after the sum.  Rounding the
    cotangent first gives other numbers; bf16_matmul matches the source."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 33)).astype(np.float32)
    w = rng.standard_normal((33, 19)).astype(np.float32)
    g = rng.standard_normal((3, 5, 19)).astype(np.float32)

    def f(a, b):
        return jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    tdnnf.bf16_matmul(xt, wt).backward(torch.tensor(g))
    np.testing.assert_array_equal(xt.grad.numpy(), dx_j)
    np.testing.assert_array_equal(wt.grad.numpy(), dw_j)
    rounded_first = (torch.tensor(g).bfloat16().float() @ wt.detach().bfloat16().float().t())
    assert not np.array_equal(rounded_first.bfloat16().float().numpy(), dx_j)


# ------------------------------------------------------------- the trainers

def _source_steps(loss_fn, params, lr, steps):
    """The source trainers' loop (value_and_grad, optax.adam, jit) over
    `loss_fn(params) -> (loss, aux)`: per-step losses, the first step's
    gradients and the final parameters, as numpy."""
    opt = optax.adam(lr)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)

    @jax.jit
    def step(p, s):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss, g

    losses, first = [], None
    for _ in range(steps):
        p, state, loss, g = step(p, state)
        losses.append(float(loss))
        first = first or {k: np.asarray(v) for k, v in g.items()}
    return losses, first, {k: np.asarray(v) for k, v in p.items()}


def _port_steps(trainer, steps):
    losses, first = [], None
    for _ in range(steps):
        loss, _ = trainer.step()
        losses.append(float(loss))
        first = first or {k: v.grad.numpy().copy() for k, v in trainer.params.items()}
    return losses, first, trainer.numpy_params()


def _source_ce_loss(cj, feats, labels):
    model = j_tdnnf.TdnnfModel(cj, j_tdnnf.init_params(cj, 0))
    x, y = jnp.asarray(feats), jnp.asarray(labels)

    def loss_fn(p):
        logp = jax.nn.log_softmax(model.forward_utterance(p, x), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1)), {}
    return loss_fn


def _source_chain_loss(cj, feats, labels):
    model = j_tdnnf.TdnnfModel(cj, j_tdnnf.init_params(cj, 0))
    den = j_chain.DenominatorGraph.from_alignments(labels, cj.num_pdfs)
    den.leaky_hmm = 0.1
    x, y = jnp.asarray(feats), jnp.asarray(labels)

    def loss_fn(p):
        return j_chain.chain_objective(den, model.forward_utterance(p, x)[:, :y.shape[1]], y)
    return loss_fn


def _sentences(vocab, n=6, seed=12):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, vocab, rng.integers(2, 7))) for _ in range(n)]


def _source_rnnlm_loss(cfg, sentences):
    """train_rnnlm's loss over the source's own GRU step (`_step_impl`,
    vmapped over sentences) and its padding."""
    model = j_rnnlm.RnnlmModel(cfg, j_rnnlm.init_rnnlm_params(cfg, 0))
    bos_id, eos_id = cfg.vocab_size, cfg.vocab_size + 1
    T = max(len(s) for s in sentences) + 1
    inp = np.full((len(sentences), T), eos_id, np.int64)
    tgt = np.full((len(sentences), T), -1, np.int64)
    for i, s in enumerate(sentences):
        inp[i, :len(s) + 1] = [bos_id] + [model._wid(w) for w in s]
        tgt[i, :len(s) + 1] = [model._wid(w) for w in s] + [eos_id]
    step = jax.vmap(model._step_impl, in_axes=(None, 0, 0))

    def loss_fn(p):
        h = jnp.zeros((len(sentences), cfg.hidden_dim))
        total = 0.0
        for t in range(T):
            h, logp = step(p, h, jnp.asarray(inp[:, t]))
            nll = -jnp.take_along_axis(logp, jnp.maximum(jnp.asarray(tgt[:, t]), 0)[:, None],
                                       axis=1)[:, 0]
            total = total + jnp.sum(nll * (tgt[:, t] >= 0))
        return total / max(int((tgt >= 0).sum()), 1), {}
    return loss_fn


def _rnnlm_cfgs():
    kw = dict(vocab_size=13, embed_dim=6, hidden_dim=10)
    return j_rnnlm.RnnlmConfig(**kw), rnnlm.RnnlmConfig(**kw)


def _cases(data):
    feats, labels = data
    cj, ct = _cfg()
    rj, rt = _rnnlm_cfgs()
    sents = _sentences(13)
    return {
        "frame_ce": (3e-3, lambda: _source_ce_loss(cj, feats, labels),
                     lambda: j_tdnnf.init_params(cj, 0),
                     lambda: train.frame_ce_trainer(ct, feats, labels, device="cpu"),
                     lambda n: j_train.train_frame_ce(cj, feats, labels, steps=n)),
        "chain": (2e-3, lambda: _source_chain_loss(cj, feats, labels),
                  lambda: j_tdnnf.init_params(cj, 0),
                  lambda: chain.chain_trainer(ct, feats, labels, device="cpu"),
                  lambda n: j_chain.train_chain(cj, feats, labels, steps=n)),
        "rnnlm": (1e-2, lambda: _source_rnnlm_loss(rj, sents),
                  lambda: j_rnnlm.init_rnnlm_params(rj, 0),
                  lambda: rnnlm.rnnlm_trainer(rt, sents, device="cpu"),
                  lambda n: j_rnnlm.train_rnnlm(rj, sents, steps=n)),
    }


STEPS = 5


@pytest.mark.parametrize("which", ["frame_ce", "chain", "rnnlm"])
def test_five_steps_match_source(data, which):
    """Step 1's loss and gradients, and the losses of steps 1-5, within rel
    1e-4 of the source.  Parameters after 5 steps are held within 2 x 5 x lr
    absolute: Adam moves a parameter by about lr x sign(g) a step, so a
    gradient near 0 whose sign differs in the last bits moves it by up to
    2 lr a step the other way; all but a few elements must agree to 1e-5."""
    lr, loss_fn, init, port, source_trainer = _cases(data)[which]
    losses_j, g_j, p_j = _source_steps(loss_fn(), init(), lr, STEPS)
    # the loop above is the source trainer's
    for k, v in source_trainer(STEPS).items():
        np.testing.assert_allclose(p_j[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    losses_t, g_t, p_t = _port_steps(port(), STEPS)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    assert set(g_t) == set(g_j) and set(p_t) == set(p_j)
    for k in g_j:
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(g_j[k]).max() + 1e-9, err_msg=k)
    off = 0
    for k in p_j:
        assert p_t[k].shape == p_j[k].shape and p_t[k].dtype == np.float32, k
        d = np.abs(p_t[k] - p_j[k])
        assert d.max() <= 2 * STEPS * lr, k
        off += int((d > 1e-5).sum())
    assert off <= max(3, sum(v.size for v in p_j.values()) // 1000), off


@pytest.mark.parametrize("which", ["frame_ce", "chain"])
def test_bf16_step_matches_source(data, which):
    """One step of a bf16 TDNN-F: the loss within rel 1e-4 and each
    gradient within 2^-7 relative of its largest element (every gradient is
    a bf16 value; a product summed in another order may round one element
    to its neighbour, 2^-8 apart)."""
    feats, labels = data
    cj, ct = _cfg("bfloat16")
    loss_fn = (_source_ce_loss if which == "frame_ce" else _source_chain_loss)(
        cj, feats, labels)
    (loss_j, _), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in j_tdnnf.init_params(cj, 0).items()})
    trainer = (train.frame_ce_trainer if which == "frame_ce" else chain.chain_trainer)(
        ct, feats, labels, device="cpu")
    loss_t, _ = trainer.step()
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)
    for k, v in g_j.items():
        v = np.asarray(v)
        got = trainer.params[k].grad.numpy()
        if k.endswith(("_w", "_lin", "_l", "_l2")):  # products' weights: bf16 values
            np.testing.assert_array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))
        np.testing.assert_allclose(got, v, rtol=0, atol=2.0 ** -7 * np.abs(v).max() + 1e-9,
                                   err_msg=k)


def test_trainers_return_source_keys(data):
    feats, labels = data
    _, ct = _cfg()
    got = train.train_frame_ce(ct, feats, labels, steps=2, device="cpu")
    want = tdnnf.init_params(ct, 0)
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype == np.float32 for k in want)
    got = chain.train_chain(ct, feats, labels, steps=2, device="cpu")
    assert set(got) == set(want)
    _, rt = _rnnlm_cfgs()
    got = rnnlm.train_rnnlm(rt, _sentences(13), steps=2, device="cpu")
    assert set(got) == set(rnnlm.init_rnnlm_params(rt, 0))
