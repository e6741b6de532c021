"""Pytree dataclass helper.

The reference keeps its scene model as plain Julia structs
(`/root/reference/src/spira-metal-optimized.jl:282-354`) and then serializes
them to flat SoA float arrays for the GPU (`prepare_scene_data`, `:515-542`).
This design skips the serialization step entirely: scene objects
*are* structure-of-array pytrees of `jnp` arrays, registered with JAX so they
can flow through `jit` / `grad` / `shard_map` directly.
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls=None, *, meta_fields: tuple = ()):
    """Register a frozen dataclass as a JAX pytree.

    ``meta_fields`` are static (hashed into the jit cache key); everything else
    is a traced array leaf.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        )
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=tuple(meta_fields)
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def replace(obj, **kwargs):
    """Functional field update for pytree dataclasses."""
    return dataclasses.replace(obj, **kwargs)
