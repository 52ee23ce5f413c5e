"""Data-parallel training tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import optax
import pytest

from cirkit_tpu.models import image_data
from cirkit_tpu.parallel import default_mesh, fit
from cirkit_tpu.parallel.training import data_parallel_step, replicate_store, shard_batch, split_trainable
from cirkit_tpu.pipeline import PipelineContext


def _small_image_circuit(ctx):
    sc = image_data(
        (1, 4, 4),
        "quad-tree-2",
        input_layer="categorical",
        num_input_units=4,
        sum_product_layer="cp",
        num_sum_units=4,
    )
    return ctx.compile(sc)


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


def test_fit_single_device_decreases_nll():
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    data = np.random.default_rng(0).integers(0, 256, size=(256, 16))
    store, losses = fit(
        cc, data, num_epochs=4, batch_size=64, optimizer=optax.adam(5e-2),
        key=jax.random.PRNGKey(0),
    )
    assert losses[-1] < losses[0]


@pytest.mark.slow
def test_fit_multichip_matches_single_chip():
    """DP training over 8 devices must produce the same losses as 1 device
    (identical math, batch just sharded)."""
    data = np.random.default_rng(1).integers(0, 256, size=(128, 16))

    def run(mesh):
        ctx = PipelineContext(semiring="lse-sum", fold=True, seed=7)
        cc = _small_image_circuit(ctx)
        _, losses = fit(
            cc, data, num_epochs=2, batch_size=32, optimizer=optax.adam(1e-2),
            mesh=mesh, key=jax.random.PRNGKey(0), shuffle=False,
        )
        return losses

    losses_1 = run(None)
    losses_8 = run(default_mesh(8))
    np.testing.assert_allclose(losses_1, losses_8, rtol=1e-8)


@pytest.mark.parametrize("optimizer", ["adam", "adam_lowmem"])
def test_fit_on_a_mesh_compiles_its_step_once(monkeypatch, optimizer):
    """The fresh optimizer state is placed like the step's outputs, so the
    second step reuses the first step's program."""
    import cirkit_tpu.parallel.training as T
    from cirkit_tpu.parallel.optimizers import adam_lowmem

    made = []

    def spy(*args, **kwargs):
        made.append(data_parallel_step(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(T, "data_parallel_step", spy)
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    data = np.random.default_rng(3).integers(0, 256, size=(32, 16))
    opt = optax.adam(1e-2) if optimizer == "adam" else adam_lowmem(1e-2)
    _, losses = fit(cc, data, num_epochs=3, batch_size=16, optimizer=opt, mesh=default_mesh(2))
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert made[0]._cache_size() == 1


def test_data_parallel_step_shards_batch():
    mesh = default_mesh(8)
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    trainable, frozen = split_trainable(cc, ctx.parameters)
    trainable = replicate_store(trainable, mesh)
    frozen = replicate_store(frozen, mesh)
    opt = optax.sgd(1e-2)
    step = data_parallel_step(cc, opt, mesh=mesh)
    batch = shard_batch(
        np.random.default_rng(2).integers(0, 256, size=(64, 16)), mesh
    )
    # the input really is sharded over the 8 devices
    assert len(batch.sharding.device_set) == 8
    trainable2, _, loss = step(trainable, frozen, opt.init(trainable), batch)
    assert np.isfinite(float(loss))
    # outputs stay replicated
    some = next(iter(trainable2.values()))
    assert len(some.sharding.device_set) == 8


def test_fit_batch_not_divisible_raises():
    mesh = default_mesh(8)
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    with pytest.raises(ValueError, match="divide"):
        fit(cc, np.zeros((64, 16), dtype=np.int64), batch_size=31, mesh=mesh)


@pytest.mark.slow
def test_fit_partial_final_batch_trains_every_sample():
    """A trailing partial batch is zero-padded and weighted instead of
    dropped: fit over N samples with batch_size not dividing N must match a
    manual loop that weights the padded rows to zero (exact same updates)."""
    import jax.numpy as jnp

    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    data = np.random.default_rng(1).integers(0, 256, size=(100, 16))  # 100 = 64 + 36
    opt = optax.sgd(0.05)

    store, losses = fit(
        cc, data, store=dict(ctx.parameters), num_epochs=1, batch_size=64,
        optimizer=opt, key=jax.random.PRNGKey(3), shuffle=False,
    )
    assert len(losses) == 2  # both batches trained, including the partial one

    # manual reference: same two weighted steps
    trainable, frozen = split_trainable(cc, ctx.parameters)
    trainable = {k: jnp.array(v) for k, v in trainable.items()}
    opt_state = opt.init(trainable)
    step = data_parallel_step(cc, opt, weighted=True)
    d32 = data.astype(np.int32)
    b1 = jnp.asarray(d32[:64])
    w1 = jnp.ones(64, jnp.float32)
    trainable, opt_state, l1 = step(trainable, frozen, opt_state, b1, w1)
    b2 = jnp.asarray(np.concatenate([d32[64:], np.zeros((28, 16), np.int32)]))
    w2 = jnp.asarray(np.concatenate([np.ones(36), np.zeros(28)]), jnp.float32)
    trainable, opt_state, l2 = step(trainable, frozen, opt_state, b2, w2)

    np.testing.assert_allclose(losses, [float(l1), float(l2)], rtol=1e-9)
    for k, v in trainable.items():
        np.testing.assert_allclose(np.asarray(store[k]), np.asarray(v), rtol=1e-9)


def test_fit_dataset_smaller_than_batch_trains_one_weighted_step():
    """A dataset smaller than one batch is padded and trained as a single
    weighted step — not silently skipped."""
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    data = np.random.default_rng(5).integers(0, 256, size=(10, 16))
    store, losses = fit(
        cc, data, num_epochs=3, batch_size=64, optimizer=optax.sgd(0.05),
        key=jax.random.PRNGKey(0),
    )
    assert len(losses) == 3  # one step per epoch
    assert losses[-1] < losses[0]


@pytest.mark.slow
def test_evaluate_ll_matches_direct_and_shards():
    """evaluate_ll: batched + padded evaluation equals the direct mean LL,
    on one device and over the 8-device mesh."""
    import jax.numpy as jnp

    from cirkit_tpu.parallel import evaluate_ll

    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    data = np.random.default_rng(9).integers(0, 256, size=(100, 16))  # partial batch
    direct = float(jnp.mean(cc.evaluate(ctx.parameters, jnp.asarray(data))))
    got = evaluate_ll(cc, data, store=ctx.parameters, batch_size=32)
    np.testing.assert_allclose(got, direct, rtol=1e-6)
    got_mesh = evaluate_ll(
        cc, data, store=ctx.parameters, batch_size=32, mesh=default_mesh(8)
    )
    np.testing.assert_allclose(got_mesh, direct, rtol=1e-6)


@pytest.mark.slow
def test_zero1_sharded_optimizer_matches_replicated():
    """ZeRO-1: optimizer state sharded over the data axis, gradients
    reduce-scattered, updates all-gathered — numerically identical to the
    replicated data-parallel step, with the Adam moments actually sharded."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cirkit_tpu.parallel.training import shard_opt_state_zero1

    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    mesh = default_mesh(8)
    trainable, frozen = split_trainable(cc, ctx.parameters)
    data = np.random.default_rng(4).integers(0, 256, size=(64, 16)).astype(np.int32)
    opt = optax.adam(1e-2)

    # replicated reference: two steps
    tr_r = replicate_store(trainable, mesh)
    fr_r = replicate_store(frozen, mesh)
    st_r = opt.init(tr_r)
    step_r = data_parallel_step(cc, opt, mesh=mesh)
    b1, b2 = shard_batch(data[:32], mesh), shard_batch(data[32:], mesh)
    tr_r, st_r, l1r = step_r(tr_r, fr_r, st_r, b1)
    tr_r, st_r, l2r = step_r(tr_r, fr_r, st_r, b2)

    # ZeRO-1 step
    tr_z = replicate_store(trainable, mesh)
    fr_z = replicate_store(frozen, mesh)
    st_z = shard_opt_state_zero1(opt.init(tr_z), mesh)
    step_z = data_parallel_step(cc, opt, mesh=mesh, zero1=True)
    tr_z, st_z, l1z = step_z(tr_z, fr_z, st_z, shard_batch(data[:32], mesh))
    tr_z, st_z, l2z = step_z(tr_z, fr_z, st_z, shard_batch(data[32:], mesh))

    np.testing.assert_allclose([float(l1z), float(l2z)], [float(l1r), float(l2r)], rtol=1e-12)
    for k in tr_r:
        np.testing.assert_allclose(
            np.asarray(tr_z[k]), np.asarray(tr_r[k]), rtol=1e-12, atol=1e-15, err_msg=k
        )
    # the moments must actually be sharded over the data axis
    sharded_leaves = [
        leaf
        for leaf in jax.tree_util.tree_leaves(st_z)
        if hasattr(leaf, "sharding")
        and leaf.ndim >= 1
        and leaf.sharding.spec == P("data")
    ]
    assert sharded_leaves, "expected at least one ZeRO-sharded optimizer leaf"


def test_fit_sample_weight_matches_replicated_dataset():
    """Integer sample weights must train exactly like the correspondingly
    replicated dataset: the weighted loss is sum w ll / sum w, so with the
    same init and full-batch steps the two runs coincide."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(6, 16))
    weights = np.array([2, 1, 3, 1, 2, 1], np.float32)
    replicated = np.repeat(data, weights.astype(int), axis=0)  # 10 rows

    def run(d, sw, bs):
        ctx = PipelineContext(semiring="lse-sum", fold=True, seed=7)
        cc = _small_image_circuit(ctx)
        return fit(
            cc, d, store=dict(ctx.parameters), num_epochs=3, batch_size=bs,
            optimizer=optax.sgd(0.05), key=jax.random.PRNGKey(0),
            shuffle=False, sample_weight=sw,
        )

    store_r, losses_r = run(replicated, None, 10)
    store_w, losses_w = run(data, weights, 6)
    np.testing.assert_allclose(losses_w, losses_r, rtol=1e-9)
    for k in store_r:
        np.testing.assert_allclose(
            np.asarray(store_w[k]), np.asarray(store_r[k]), rtol=1e-9, err_msg=k
        )


def test_fit_sample_weight_validation():
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = _small_image_circuit(ctx)
    data = np.zeros((8, 16), np.int32)
    with pytest.raises(ValueError, match="entries for"):
        fit(cc, data, batch_size=8, sample_weight=np.ones(5))
    with pytest.raises(ValueError, match="finite and >= 0"):
        fit(cc, data, batch_size=8, sample_weight=-np.ones(8))
