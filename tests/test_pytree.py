"""The local frozen-dataclass pytree helper (utils/pytree.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pegasus_tpu.utils import pytree


@pytree.dataclass
class _Box:
    values: jnp.ndarray
    size: int = pytree.field(pytree_node=False, default=4)


def test_static_fields_are_not_leaves():
    b = _Box(values=jnp.arange(3.0), size=7)
    leaves, treedef = jax.tree.flatten(b)
    assert len(leaves) == 1
    again = jax.tree.unflatten(treedef, leaves)
    assert again.size == 7
    # the static field is part of the structure
    assert treedef != jax.tree.flatten(_Box(jnp.arange(3.0), 8))[1]
    with pytest.raises(AttributeError):
        b.size = 3  # frozen


def test_replace_returns_a_new_instance():
    b = _Box(values=jnp.zeros(2))
    c = b.replace(values=jnp.ones(2))
    np.testing.assert_array_equal(b.values, 0.0)
    np.testing.assert_array_equal(c.values, 1.0)
    assert c.size == b.size == 4


def test_static_field_under_jit():
    traces = []

    @jax.jit
    def f(b):
        traces.append(1)
        return jnp.zeros(b.size) + b.values.sum()  # size must be concrete

    assert f(_Box(jnp.ones(3), size=2)).shape == (2,)
    assert f(_Box(jnp.ones(3), size=2)).shape == (2,)
    assert len(traces) == 1  # same static value: no retrace
    assert f(_Box(jnp.ones(3), size=5)).shape == (5,)
    assert len(traces) == 2
    out = jax.vmap(lambda b: b.values * 2)(_Box(jnp.ones((4, 3))))
    assert out.shape == (4, 3)
