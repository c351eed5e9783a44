"""Frozen dataclasses registered as JAX pytrees.

``@pytree_dataclass`` makes a frozen dataclass whose fields are pytree
children, except those declared with ``static_field()``, which become part
of the tree structure (hashable, compared by value, static under ``jit``).
Instances get ``.replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(cls, frozen=True)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)
