"""The pytree dataclass helper (svi_mapper_tpu.utils.struct)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svi_mapper_tpu.utils import struct


@struct.dataclass
class _Pair:
    a: jax.Array
    b: jax.Array | None = None
    n: int = struct.field(pytree_node=False, default=3)


def test_dataclass_is_a_frozen_pytree_with_replace():
    p = _Pair(jnp.ones(2), jnp.zeros(3))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                       # `n` is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.n == 3 and np.array_equal(back.a, p.a)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(2)
    q = p.replace(b=None)
    assert q.b is None and p.b is not None        # replace copies
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, p)
    assert np.array_equal(doubled.a, 2 * np.ones(2))


def test_static_field_is_part_of_the_jit_cache_key():
    traces = []

    @jax.jit
    def scale(p):
        traces.append(p.n)                        # runs only while tracing
        return p.a * p.n

    x = jnp.arange(3.0)
    assert np.array_equal(scale(_Pair(x)), 3 * np.arange(3.0))
    assert np.array_equal(scale(_Pair(x + 1)), 3 * np.arange(1.0, 4.0))
    assert np.array_equal(scale(_Pair(x, n=5)), 5 * np.arange(3.0))
    assert traces == [3, 5]                       # new static value retraces
    # vmap maps the array leaves and leaves the static field alone
    out = jax.vmap(lambda p: p.a * p.n)(_Pair(jnp.ones((4, 2)), n=2))
    assert out.shape == (4, 2) and float(out[0, 0]) == 2.0
