"""vosk_tpu_torch/ops/gather.py against the JAX package's gathers.

gather_rows_plain (what gather_rows runs on CPU tensors) must be bit-equal
to `onehot_gather`, `onehot_gather_i32` and the Pallas kernel run through
the interpreter, at the tests/test_gather.py shapes and on out-of-range
indices.  tests/test_torch_cuda.py compares the CUDA kernel with the plain
version on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vosk_tpu.ops.gather import _pallas_gather, onehot_gather, onehot_gather_i32
from vosk_tpu_torch.ops.gather import GATHER_STAGES, gather_rows, gather_rows_plain


def _port(table, idx):
    return gather_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()


@pytest.mark.parametrize("B,P,N", [(2, 300, 1000), (3, 6008, 4096), (1, 64, 17)])
def test_plain_matches_onehot_gather(B, P, N):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((B, P)).astype(np.float32)
    idx = rng.integers(0, P, (B, N)).astype(np.int32)
    ref = np.asarray(onehot_gather(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(_port(table, idx), ref)  # bit-equal


def test_plain_matches_onehot_gather_i32_full_range():
    rng = np.random.default_rng(1)
    table = rng.integers(-(2**31), 2**31 - 1, (2, 500), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, 500, (2, 700)).astype(np.int32)
    ref = np.asarray(onehot_gather_i32(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(_port(table, idx), ref)


@pytest.mark.parametrize("B,P,N", [(2, 300, 1000), (2, 6008, 5000)])
def test_plain_matches_pallas_interpret(B, P, N):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((B, P)).astype(np.float32)
    idx = rng.integers(0, P, (B, N)).astype(np.int32)
    ref = np.asarray(_pallas_gather(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    np.testing.assert_array_equal(_port(table, idx), ref)


def test_out_of_range_gives_zero_like_jax():
    rng = np.random.default_rng(3)
    P = 300
    table = rng.standard_normal((2, P)).astype(np.float32)
    idx = rng.integers(0, P, (2, 64)).astype(np.int32)
    idx[0, :4] = [P, P + 5, -1, -(2**31)]
    idx[1, -3:] = [P - 1, 2**31 - 1, P]
    ref = np.asarray(onehot_gather(jnp.asarray(table), jnp.asarray(idx)))
    got = _port(table, idx)
    np.testing.assert_array_equal(got, ref)
    assert (got[0, :4] == 0).all() and got[1, -3] == table[1, P - 1]


def test_cpu_uses_plain_and_counts_no_launch():
    before = gather_rows.launches
    t = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    i = torch.tensor([[5, 0, 9], [1, -1, 2]], dtype=torch.int32)
    assert gather_rows(t, i).tolist() == [[5, 0, 0], [7, 0, 8]]
    assert gather_rows.launches == before


@pytest.mark.parametrize("stage", [None, *GATHER_STAGES])
def test_stage_choice_leaves_the_result(stage):
    """`stage` only picks how the kernel reads the table row on the card
    (in place, staged, multicast); on CPU tensors every choice is the plain
    version, bit-equal to onehot_gather."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((3, 301)).astype(np.float32)
    idx = rng.integers(-2, 303, (3, 4099)).astype(np.int32)
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx), stage=stage).numpy()
    np.testing.assert_array_equal(got, np.asarray(onehot_gather(jnp.asarray(table),
                                                                jnp.asarray(idx))))


@pytest.mark.parametrize("bad", ["dtype", "idx_dtype", "shape", "contig", "rows", "stage"])
def test_wrapper_rejects(bad):
    t = torch.zeros((2, 8), dtype=torch.float32)
    i = torch.zeros((2, 4), dtype=torch.int32)
    if bad == "dtype":
        t = t.double()
    elif bad == "idx_dtype":
        i = i.long()
    elif bad == "shape":
        t = t[0]
    elif bad == "contig":
        i = torch.zeros((4, 2), dtype=torch.int32).t()
    elif bad == "rows":
        i = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        gather_rows(t, i, stage="bulk" if bad == "stage" else None)
