"""bf16-resident weight stores: slot detection, fast-grade forward accuracy
and query compatibility."""

import jax.numpy as jnp
import numpy as np
import pytest

from cirkit_tpu.backend.jax import bf16_weight_store, weight_slots
from cirkit_tpu.models import image_data
from cirkit_tpu.pipeline import PipelineContext


def _circuit(sp, optimize=True, seed=4):
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize, seed=seed)
    sc = image_data(
        (1, 4, 4), "quad-graph", input_layer="categorical",
        num_input_units=4, sum_product_layer=sp, num_sum_units=4,
    )
    return ctx, ctx.compile(sc)


@pytest.mark.parametrize("sp", ["cp", "tucker"])
@pytest.mark.slow
def test_bf16_weight_store_fast_grade_forward(sp):
    ctx, cc = _circuit(sp)
    store32 = {k: jnp.asarray(v, jnp.float32) for k, v in cc.restrict_store(ctx.parameters).items()}
    storebf = bf16_weight_store(cc, store32)
    slots = weight_slots(cc)
    assert slots and all(storebf[s].dtype == jnp.bfloat16 for s in slots)
    # non-weight slots keep their dtype
    assert all(storebf[k].dtype == v.dtype for k, v in store32.items() if k not in slots)

    x = jnp.asarray(np.random.default_rng(0).integers(0, 256, size=(16, 16), dtype=np.int32))
    a = np.asarray(cc.evaluate(store32, x))
    b = np.asarray(cc.evaluate(storebf, x))
    assert np.isfinite(b).all()
    # round-to-nearest bf16 weight grade (documented fast-mode bound)
    np.testing.assert_allclose(b, a, atol=2e-2)


@pytest.mark.slow
def test_bf16_weight_store_queries_run():
    import jax

    from cirkit_tpu.backend.jax import IntegrateQuery, MAPQuery

    ctx, cc = _circuit("cp")
    store = bf16_weight_store(
        cc, {k: jnp.asarray(v, jnp.float32) for k, v in cc.restrict_store(ctx.parameters).items()}
    )
    x = jnp.asarray(np.random.default_rng(1).integers(0, 256, size=(4, 16), dtype=np.int32))
    mask = np.zeros((4, 16), dtype=bool)
    mask[:, :8] = True
    marg = IntegrateQuery(cc)(x, integrate_vars=jnp.asarray(mask), store=store)
    assert np.isfinite(np.asarray(marg)).all()
    asg, val = MAPQuery(cc)(x, evidence_mask=jnp.asarray(~mask), store=store)
    assert np.isfinite(np.asarray(val)).all()


@pytest.mark.slow
def test_export_circuit_roundtrip_and_store_swap():
    """StableHLO export: the deserialized artifact reproduces evaluate()
    bitwise, replays on a NEW store of the same shapes, and the integrate
    variant carries runtime evidence masks into serving."""
    from cirkit_tpu.backend.jax import export_circuit, load_exported
    from cirkit_tpu.backend.jax.queries import IntegrateQuery

    ctx, cc = _circuit("tucker")
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.integers(0, 256, size=(4, 16)), jnp.int32)
    store = cc.restrict_store(ctx.parameters)

    blob = export_circuit(cc, x, store=ctx.parameters)
    assert isinstance(blob, bytes) and len(blob) < 5_000_000
    fn = load_exported(blob)
    want = np.asarray(cc.evaluate(store, x))
    np.testing.assert_array_equal(np.asarray(fn(store, x)), want)

    # replay on a different parameterization without re-exporting
    ctx2, cc2 = _circuit("tucker", seed=9)
    store2 = cc2.restrict_store(ctx2.parameters)
    store2 = {k: store2[k] for k in store}  # same shapes, new values
    want2 = np.asarray(cc.evaluate(store2, x))
    np.testing.assert_array_equal(np.asarray(fn(store2, x)), want2)

    # integrate variant: (store, x, mask)
    blob_m = export_circuit(cc, x, store=ctx.parameters, query="integrate")
    fn_m = load_exported(blob_m)
    mask = jnp.asarray(rng.random((4, 16)) < 0.5)
    want_m = np.asarray(
        IntegrateQuery(cc)(x, integrate_vars=mask, store=store)
    )
    np.testing.assert_allclose(
        np.asarray(fn_m(store, x, mask)), want_m, rtol=1e-6, atol=1e-12
    )

    with pytest.raises(ValueError, match="Unknown query"):
        export_circuit(cc, x, store=ctx.parameters, query="sample")
