"""Tensor-parallel MAP / conditional sampling, manually partitioned.

The GSPMD path (tests/parallel via the dryrun) proves TP-sharded stores give
correct query answers. These tests pin the *manually partitioned* path
(``MAPQuery(cc, mesh=...)`` / ``SamplingQuery(cc, mesh=...)``,
``queries.TPRouting``): the routing passes run under ``shard_map``, every
contraction sees only its local weight shard, and the cross-shard combines
are explicit collectives — the configuration the reference has no
counterpart for (single-device torch; SURVEY.md §2.7)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from cirkit_tpu.backend.jax.queries import MAPQuery, SamplingQuery
from cirkit_tpu.models import image_data
from cirkit_tpu.parallel.tensor import shard_store_tp, tp_slot_specs
from cirkit_tpu.pipeline import PipelineContext


def _compile(units: int = 16, input_layer: str = "categorical"):
    ctx = PipelineContext(backend="jax", semiring="lse-sum")
    sc = image_data(
        (1, 2, 2),
        region_graph="quad-tree-2",
        input_layer=input_layer,
        num_input_units=units,
        sum_product_layer="tucker",
        num_sum_units=units,
    )
    cc = ctx.compile(sc)
    return cc, dict(ctx.parameters)


def _mesh(shape, axes):
    return Mesh(np.array(jax.devices()).reshape(shape), axes)


def _data(num_vars=4, batch=8, continuous=False):
    rng = np.random.default_rng(0)
    if continuous:
        x = rng.normal(size=(batch, num_vars)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (batch, num_vars)).astype(np.int32)
    mask = rng.random((batch, num_vars)) < 0.5
    return x, mask


def _assert_tp_matches(cc, store, mesh, x, mask, *, rtol=1e-9):
    asg1, val1 = MAPQuery(cc)(x, evidence_mask=mask, store=store)
    s1, le1 = SamplingQuery(cc).conditional(
        x, evidence_mask=mask, key=jax.random.PRNGKey(7), store=store
    )
    tp_store, _ = shard_store_tp(cc, store, mesh)
    asg2, val2 = MAPQuery(cc, mesh=mesh)(x, evidence_mask=mask, store=tp_store)
    np.testing.assert_array_equal(np.asarray(asg2), np.asarray(asg1))
    np.testing.assert_allclose(np.asarray(val2), np.asarray(val1), rtol=rtol)
    s2, le2 = SamplingQuery(cc, mesh=mesh).conditional(
        x, evidence_mask=mask, key=jax.random.PRNGKey(7), store=tp_store
    )
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(s1))
    np.testing.assert_allclose(np.asarray(le2), np.asarray(le1), rtol=rtol)


def test_tp_queries_match_single_device_xla():
    cc, store = _compile()
    assert tp_slot_specs(cc, 2), "expected shardable slots"
    x, mask = _data()
    _assert_tp_matches(cc, store, _mesh((2, 4), ("model", "data")), x, mask)


@pytest.mark.slow
@pytest.mark.parametrize(
    "shape,axes", [((4, 2), ("model", "data")), ((8,), ("model",))]
)
def test_tp_queries_mesh_grid(shape, axes):
    cc, store = _compile()
    x, mask = _data()
    _assert_tp_matches(cc, store, _mesh(shape, axes), x, mask)


@pytest.mark.slow
def test_tp_marginal_map_matches_single_device():
    cc, store = _compile()
    x, mask = _data()
    rng = np.random.default_rng(3)
    mg = (~mask) & (rng.random(mask.shape) < 0.5)
    asg1, val1 = MAPQuery(cc)(x, evidence_mask=mask, marginalize_vars=mg, store=store)
    mesh = _mesh((2, 4), ("model", "data"))
    tp_store, _ = shard_store_tp(cc, store, mesh)
    asg2, val2 = MAPQuery(cc, mesh=mesh)(
        x, evidence_mask=mask, marginalize_vars=mg, store=tp_store
    )
    np.testing.assert_array_equal(np.asarray(asg2), np.asarray(asg1))
    np.testing.assert_allclose(np.asarray(val2), np.asarray(val1), rtol=1e-9)


@pytest.mark.slow
def test_tp_queries_gaussian_leaves():
    """Continuous leaves: the sharded sample_selected psum-combine path."""
    cc, store = _compile(input_layer="gaussian")
    x, mask = _data(continuous=True)
    _assert_tp_matches(cc, store, _mesh((2, 4), ("model", "data")), x, mask)


def test_tp_unconditional_sampling_matches_single_device():
    cc, store = _compile()
    mesh = _mesh((2, 4), ("model", "data"))
    tp_store, _ = shard_store_tp(cc, store, mesh)
    u1, _ = SamplingQuery(cc)(8, key=jax.random.PRNGKey(3), store=store)
    u2, _ = SamplingQuery(cc, mesh=mesh)(8, key=jax.random.PRNGKey(3), store=tp_store)
    np.testing.assert_array_equal(np.asarray(u2), np.asarray(u1))
