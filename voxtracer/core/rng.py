"""Counter-based hash RNG for the sampling hot path.

The reference uses a thread-local xorshift32 seeded by WangHash
(tmpl8math.cpp:16-38,119-133) — fast, stateful, irreproducible across
runs.  JAX's default sampler (`jax.random`, threefry) is deterministic
but runs a counter cipher for each of ~14 wide streams per bounce.

This module is the middle path: a stateless PCG-style integer hash over
(key, salt, counter) — deterministic like threefry, a few integer ops
per value, with the statistical quality rendering needs
(PCG output permutation, the standard choice in GPU path tracers).  It is
NOT crypto-grade; estimator semantics are unchanged (same distributions,
different sample values), selected via RenderConfig.rng.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
U32 = jnp.uint32

# NumPy scalars, not device arrays: traces take them as literals instead
# of capturing module-level arrays as constants
_GOLDEN = np.uint32(0x9E3779B9)
_PRIME1 = np.uint32(0x85EBCA6B)


def _pcg(x):
    """PCG-RXS-M-XS output permutation over uint32 (O'Neill 2014)."""
    x = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    x = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x) \
        * jnp.uint32(277803737)
    return (x >> jnp.uint32(22)) ^ x


def key_seed(key) -> jnp.ndarray:
    """Collapse a jax PRNG key to one uint32 seed scalar (cheap; the key
    machinery still provides the fold_in tree structure above us).
    Words mix through _pcg rounds, not linear combination, so nearby
    keys select unrelated hash functions."""
    kd = jax.random.key_data(key).astype(U32).reshape(-1)
    s = _pcg(kd[0])
    for i in range(1, kd.shape[0]):
        s = _pcg(s ^ kd[i])
    return s


def hash_bits(key, salt: int, shape) -> jnp.ndarray:
    """uint32 hash stream: two PCG rounds over (seed, salt, counter).

    The (seed, salt) pair enters through its OWN scalar _pcg round, so
    distinct streams are independent hash functions rather than constant
    counter offsets of one global sequence (additively-mixed salts put
    every stream on one PCG orbit: two streams whose offsets landed
    within the lane count of each other repeated sample values
    lane-for-lane).  The extra round is scalar work, not
    per-element."""
    seed = key_seed(key)
    n = 1
    for s in shape:
        n *= s
    idx = jax.lax.iota(U32, n)
    base = _pcg(seed ^ (jnp.uint32(salt) * _GOLDEN))
    # both rounds are keyed: pcg(pcg(idx ^ b) ^ b*P) is a two-input hash,
    # not one global sequence sampled at different lanes
    x = _pcg(idx ^ base)
    return _pcg(x ^ (base * _PRIME1)).reshape(shape)


def hash_uniform(key, salt: int, shape) -> jnp.ndarray:
    """f32 uniforms in [0, 1): top 24 hash bits scaled."""
    bits = hash_bits(key, salt, shape)
    return (bits >> jnp.uint32(8)).astype(F32) * F32(1.0 / (1 << 24))


def hash_normal(key, salt: int, shape) -> jnp.ndarray:
    """f32 standard normals via Box-Muller over two hash-uniform streams."""
    u1 = hash_uniform(key, salt, shape)
    u2 = hash_uniform(key, salt + 0x5D0, shape)
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u1, 1e-12)))
    return r * jnp.cos((2.0 * jnp.pi) * u2)
