"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` makes an immutable dataclass whose fields are pytree
children, so instances pass through ``jit``, ``vmap``, ``lax.scan`` and
``tree_map`` like tuples of arrays. ``struct.field(pytree_node=False)``
marks a field as static metadata (part of the tree structure, hashed into
the jit cache key) instead of a child. Every instance has
``.replace(**updates)``.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (static fields as metadata)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta)
