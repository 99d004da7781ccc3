"""The package's pytree dataclasses (``unmanned_aerial_vehicles_tpu.struct``)."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from unmanned_aerial_vehicles_tpu import struct


@struct.dataclass
class Point:
    x: jnp.ndarray
    y: jnp.ndarray = 0.0
    label: str = struct.field(pytree_node=False, default="p")


@struct.dataclass
class Holder:
    inner: Point = struct.field(default_factory=lambda: Point(1.0))
    n: int = struct.field(pytree_node=False, default=3)


def test_flatten_unflatten_keeps_static_fields():
    p = Point(jnp.ones(2), jnp.zeros(2), label="a")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                      # label is static
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.label == "a" and bool(jnp.all(q.x == 1.0))
    # static fields are part of the treedef
    other = jax.tree_util.tree_structure(Point(jnp.ones(2), label="b"))
    assert other != treedef


def test_replace_and_frozen():
    p = Point(jnp.ones(2))
    q = p.replace(y=jnp.full(2, 2.0), label="q")
    assert q.label == "q" and float(q.y[0]) == 2.0 and p.label == "p"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = 0.0


def test_through_jit_and_vmap():
    @jax.jit
    def f(p):
        return p.replace(x=p.x + p.y * (2.0 if p.label == "p" else 3.0))

    out = f(Point(jnp.ones(3), jnp.ones(3)))
    assert out.label == "p" and bool(jnp.all(out.x == 3.0))
    batched = jax.vmap(lambda p: p.x * 2.0)(Point(jnp.arange(4.0), jnp.zeros(4)))
    assert batched.shape == (4,)


def test_nested_defaults_and_tree_map():
    h = Holder()
    assert h.n == 3 and float(h.inner.x) == 1.0
    doubled = jax.tree_util.tree_map(lambda a: 2 * a, h)
    assert float(doubled.inner.x) == 2.0 and doubled.n == 3
    assert jax.tree_util.tree_structure(h).num_leaves == 2


def test_package_configs_are_pytrees():
    from unmanned_aerial_vehicles_tpu.loop import FlightResumeState

    rs = FlightResumeState(carry=(jnp.ones(2),), tick=5, meta=(1, 2))
    leaves, treedef = jax.tree_util.tree_flatten(rs)
    assert len(leaves) == 1
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tick == 5 and back.meta == (1, 2)
