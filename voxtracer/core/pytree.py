"""Frozen dataclasses that are JAX pytrees (every field is a leaf)."""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """`@dataclass` for scene and parameter structs: frozen, registered
    with jax.tree_util, and given a `replace(**changes)` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = dataclasses.replace
    return cls
