"""The custom-VJP table lookups of the differentiable march
(diff/volumetric.py `_rows`, `_bsig_rows`): forward is XLA's take,
backward a bf16 one-hot product with f32 accumulation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxtracer.diff.volumetric import _bsig_rows, _rows


@pytest.mark.parametrize("kind", ["rows", "bsig"])
def test_lookup_gradient_matches_autodiff(kind):
    rng = np.random.default_rng(0)
    n, k = 4096, 256
    idx = jnp.asarray(rng.integers(0, k, n).astype(np.int32))
    if kind == "rows":
        table = jnp.asarray(rng.random((k, 3)).astype(np.float32))
        ct = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
        fn = _rows
    else:
        table = jnp.asarray(rng.random(k).astype(np.float32))
        ct = jnp.asarray(rng.normal(size=n).astype(np.float32))
        fn = _bsig_rows

    def take(t, i):
        return jnp.take(t, i, axis=0, mode="clip")

    np.testing.assert_array_equal(fn(table, idx), take(table, idx))
    got = jax.grad(lambda t: jnp.sum(fn(t, idx) * ct))(table)
    ref = jax.grad(lambda t: jnp.sum(take(t, idx) * ct))(table)
    # each cotangent rounds to bf16 (8 mantissa bits) before the f32 sum:
    # per-row error <= 2^-8 * sum of |cotangent| over that row's lookups
    bound = jax.grad(lambda t: jnp.sum(take(t, idx) * jnp.abs(ct)))(table)
    err = np.abs(np.asarray(got) - np.asarray(ref))
    assert (err <= 2.0 ** -8 * np.asarray(bound) + 1e-6).all()
    assert np.abs(np.asarray(ref)).max() > 1.0
