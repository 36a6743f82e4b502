"""The size-adaptive lookups of ops/segments.py against numpy.

Each helper switches at `_ONEHOT_ELEMS` between one-hot f32 contractions
and the native path (`jnp.take`, or a `lax.sort` inversion for the
scatters); both sides must return the exact integer result, including
values far above 2^24 and negative ones."""

import jax.numpy as jnp
import numpy as np
import pytest

from ddo_tpu.ops import segments as seg_ops

SIDES = ["onehot", "native"]


@pytest.fixture(params=SIDES)
def side(request, monkeypatch):
    # 1 element forces the native side at every size; 1 << 30 the one-hot
    monkeypatch.setattr(
        seg_ops, "_ONEHOT_ELEMS", 1 << 30 if request.param == "onehot" else 1
    )
    return request.param


def _ints(rng, shape):
    return rng.integers(-(1 << 30), 1 << 30, shape).astype(np.int32)


def test_take_i32(side):
    rng = np.random.default_rng(0)
    table, idx = _ints(rng, 37), rng.integers(0, 37, 53).astype(np.int32)
    got = seg_ops.take_i32(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), table[idx])


def test_take_rows_i32(side):
    rng = np.random.default_rng(1)
    table, idx = _ints(rng, (29, 5)), rng.integers(0, 29, 40).astype(np.int32)
    got = seg_ops.take_rows_i32(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), table[idx])


def test_take_bool(side):
    rng = np.random.default_rng(2)
    table, idx = rng.random(31) < 0.5, rng.integers(0, 31, 45).astype(np.int32)
    got = seg_ops.take_bool(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), table[idx])


def test_scatter_i32(side):
    rng = np.random.default_rng(3)
    perm = rng.permutation(64).astype(np.int32)
    vals = _ints(rng, 64)
    want = np.empty(64, np.int32)
    want[perm] = vals
    got = seg_ops.scatter_i32(jnp.asarray(perm), jnp.asarray(vals), 64)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_scatter_multi_i32(side):
    rng = np.random.default_rng(4)
    perm = rng.permutation(48).astype(np.int32)
    cols = [_ints(rng, 48) for _ in range(3)]
    got = seg_ops.scatter_multi_i32(
        jnp.asarray(perm), tuple(jnp.asarray(c) for c in cols), 48
    )
    assert len(got) == 3
    for g, c in zip(got, cols):
        want = np.empty(48, np.int32)
        want[perm] = c
        np.testing.assert_array_equal(np.asarray(g), want)
