"""Benchmark: the flagship circuit and its workloads on one NVIDIA GPU.

The flagship is the reference's headline configuration, the MNIST
QuadGraph circuit with Tucker sum-products and K=64 units. The reference
(BASELINE.md) runs its best (folded+optimized) forward on it in 38.6 ms for
a batch of 128 on an A100 (``notebooks/compilation-options.ipynb``); those
are the reference's own published numbers, not this program's.

``python bench.py [SECTION ...]`` runs each section (all of them by
default) in a child process of its own, one after another, so that one
process at a time holds the GPU and a failing section loses only itself.
The parent never imports JAX. Each section prints one JSON line as it
finishes, naming the device it ran on; the last line is the merged
result. A section that finds no GPU fails. The compile cache follows
``JAX_COMPILATION_CACHE_DIR``, or else ``<repo>/.jax_cache``.

Env overrides: BENCH_SUM_PRODUCT (tucker|cp|cp-t), BENCH_UNITS,
BENCH_BATCH, BENCH_ITERS, BENCH_OPTIMIZE.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_SAMPLES_PER_SEC = 128 / 0.0386  # reference folded+optimized fwd
BASELINE_FOLDED_SAMPLES_PER_SEC = 128 / 0.0758  # reference folded (unoptimized) fwd
REPO = os.path.dirname(os.path.abspath(__file__))


def _timed(fn, iters: int) -> float:
    """Best of three rounds of ``iters`` calls, synced with
    ``block_until_ready``: seconds per call."""
    from chip_smoke import warm_ms

    return warm_ms(fn, iters) / 1e3


def bench_config(sum_product: str, num_units: int, batch: int, iters: int, optimize: bool):
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    t0 = time.time()
    sc = image_data(
        (1, 28, 28),
        "quad-graph",
        input_layer="categorical",
        num_input_units=num_units,
        sum_product_layer=sum_product,
        num_sum_units=num_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize)
    cc = ctx.compile(sc)
    build_s = time.time() - t0

    store = {k: v for k, v in ctx.parameters.items() if k in cc.used_slots}
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, size=(batch, 784), dtype=np.int64)
    )
    fwd = jax.jit(lambda st, xx: cc.evaluate(st, xx))

    t0 = time.time()
    out = jax.block_until_ready(fwd(store, x))
    compile_s = time.time() - t0
    assert np.isfinite(np.asarray(out)).all(), "Non-finite benchmark outputs"
    per_batch = _timed(lambda: fwd(store, x), iters)
    return batch / per_batch, per_batch, build_s, compile_s


def bench_train(
    sum_product: str, num_units: int, batch: int, iters: int, optimize: bool,
    lowmem: bool = False,
):
    """North-star training throughput: full jitted MLE step (fwd + bwd +
    adam update) on the MNIST-shaped circuit. ``lowmem`` swaps optax.adam
    for the bf16-state stochastic-rounding Adam (docs/PERF.md)."""
    import jax
    import jax.numpy as jnp
    import optax

    from cirkit_tpu.models import image_data
    from cirkit_tpu.parallel.optimizers import adam_lowmem
    from cirkit_tpu.parallel.training import data_parallel_step, split_trainable
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, 28, 28),
        "quad-graph",
        input_layer="categorical",
        num_input_units=num_units,
        sum_product_layer=sum_product,
        num_sum_units=num_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize)
    cc = ctx.compile(sc)
    trainable, frozen = split_trainable(cc, ctx.parameters)
    optimizer = adam_lowmem(1e-2) if lowmem else optax.adam(1e-2)
    opt_state = optimizer.init(trainable)
    step = data_parallel_step(cc, optimizer)
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, size=(batch, 784), dtype=np.int32)
    )
    state = [trainable, opt_state]

    def one():
        state[0], state[1], loss = step(state[0], frozen, state[1], x)
        return loss

    per_step = _timed(one, iters)
    return batch / per_step, per_step


def bench_sos(*, batch: int, iters: int, side: int = 12, units: int = 32):
    """Sum-of-squares forward throughput under the signed log semiring: a
    non-monotonic QuadTree circuit squared via multiply(conjugate(c), c),
    running as an all-real f32 program."""
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.models import image_data
    from cirkit_tpu.models.utils import Parameterization
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, side, side),
        "quad-tree-2",
        input_layer="categorical",
        num_input_units=units,
        sum_product_layer="cp",
        num_sum_units=units,
        sum_weight_param=Parameterization(activation="none", initialization="normal"),
    )
    ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    sq = ctx.multiply(ctx.conjugate(cc), cc)
    store = sq.restrict_store(ctx.parameters)
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, size=(batch, side * side), dtype=np.int32)
    )
    fwd = jax.jit(lambda st, xx: sq.evaluate(st, xx))
    logmag, sign = fwd(store, x)
    assert np.isfinite(np.asarray(logmag)).all()
    best = _timed(lambda: fwd(store, x), iters)
    return batch / best, best


def _fwd_gflops_per_sample(cc) -> float:
    """Useful (single-pass) forward MACs x2 of the sum-style contractions,
    per sample — the numerator of the MFU figure. Elementwise input/product
    work is negligible next to the contractions."""
    from cirkit_tpu.backend.jax.layers import JaxSumLayer
    from cirkit_tpu.backend.jax.optimized import (
        JaxCPTLayer,
        JaxTensorDotLayer,
        JaxTuckerLayer,
    )

    macs = 0
    for layer in cc.layers:
        f = layer.num_folds
        if isinstance(layer, JaxTuckerLayer):
            comp = layer.num_input_units ** layer.arity
            macs += f * (layer.num_output_units * comp + comp)
        elif isinstance(layer, JaxCPTLayer):
            macs += f * layer.num_output_units * layer.num_input_units
        elif isinstance(layer, JaxTensorDotLayer):
            kj = layer._num_contract_units
            macs += f * layer.num_output_units * kj
        elif isinstance(layer, JaxSumLayer):
            macs += f * layer.num_output_units * layer.arity * layer.num_input_units
    return 2.0 * macs / 1e9


def bench_queries(sum_product: str, num_units: int, batch: int, iters: int):
    """Flagship query throughput: IntegrateQuery (50% marginalized),
    MAPQuery (50% evidence completion), SamplingQuery (unconditional).
    Pins the docs/PERF.md numbers in the driver-run artifact."""
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.queries import (
        ExpectationQuery,
        IntegrateQuery,
        MAPQuery,
        SamplingQuery,
    )
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, 28, 28),
        "quad-graph",
        input_layer="categorical",
        num_input_units=num_units,
        sum_product_layer=sum_product,
        num_sum_units=num_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    store = cc.restrict_store(ctx.parameters)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 256, size=(batch, 784), dtype=np.int32))
    mask = jnp.asarray(rng.random((batch, 784)) < 0.5)
    key = jax.random.PRNGKey(0)

    def time_it(fn, n):
        return _timed(fn, n) * 1e3  # ms

    out = {}
    iq = IntegrateQuery(cc)
    out["integrate_query_ms"] = round(
        time_it(lambda: iq(x, integrate_vars=mask, store=store), iters), 2
    )
    mq = MAPQuery(cc)
    out["map_query_ms"] = round(
        time_it(lambda: mq(x, evidence_mask=mask, store=store), max(iters // 3, 10)), 2
    )
    sq = SamplingQuery(cc)
    out["sample_query_ms"] = round(
        time_it(lambda: sq(batch, key=key, store=store)[0], 10), 1
    )
    eq = ExpectationQuery(cc)
    out["expectation_query_ms"] = round(
        time_it(lambda: eq(x, evidence_mask=mask, store=store), max(iters // 5, 3)), 2
    )
    # The r3 capability queries, regression-pinned (docs/PERF.md claims):
    # posterior marginals / cdf / quantile ride the same responsibility
    # backward; entropy is the carrier-generic bottom-up walker.
    out["marginals_query_ms"] = round(
        time_it(
            lambda: eq.marginals(x, evidence_mask=mask, store=store),
            max(iters // 5, 3),
        ),
        2,
    )
    out["cdf_query_ms"] = round(
        time_it(
            lambda: eq.cdf(x, t=127.0, evidence_mask=mask, store=store),
            max(iters // 5, 3),
        ),
        2,
    )
    out["quantile_query_ms"] = round(
        time_it(
            lambda: eq.quantile(x, q=0.5, evidence_mask=mask, store=store),
            max(iters // 5, 3),
        ),
        2,
    )
    from cirkit_tpu.backend.jax.entropy import EntropyQuery

    hq = EntropyQuery(cc)
    out["entropy_query_ms"] = round(time_it(lambda: hq(store=store), 10), 2)
    out["posterior_entropy_ms"] = round(
        time_it(
            lambda: hq(x, evidence_mask=mask, store=store), max(iters // 5, 3)
        ),
        2,
    )
    from cirkit_tpu.backend.jax.queries import mutual_information

    # One-time anchored-marginals compile on a 2-anchor call, a warm call,
    # then min-of-2 over 16 anchors so the per-call fixed costs amortize
    # the way real MI queries do.
    t0 = time.time()
    mutual_information(cc, store=store, variables=[0, 1])
    out["mi_compile_s"] = round(time.time() - t0, 1)
    mutual_information(cc, store=store, variables=[2, 3, 4, 5])
    best = None
    for lo in (6, 22):
        t0 = time.time()
        mi = jax.block_until_ready(
            mutual_information(cc, store=store, variables=list(range(lo, lo + 16)))
        )
        dt = (time.time() - t0) / 16 * 1e3
        best = dt if best is None else min(best, dt)
    out["mi_per_anchor_ms"] = round(best, 1)
    return out


def bench_em(sum_product: str, num_units: int, batch: int, iters: int):
    """EM flow-step latency on the EM-ready flagship (plain Dirichlet sum
    weights + plain categorical leaf probs): the fastest training mode —
    no optimizer state traffic."""
    import jax.numpy as jnp

    from cirkit_tpu.models import image_data
    from cirkit_tpu.parallel import em_programs
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, 28, 28),
        "quad-graph",
        input_layer="categorical",
        num_input_units=num_units,
        sum_product_layer=sum_product,
        num_sum_units=num_units,
        em_ready=True,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    flow_step, em_update, state = em_programs(cc, ctx.parameters)
    em_p, g_p = state["em_params"], state["gauss_params"]
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, size=(batch, 784), dtype=np.int32)
    )
    w = jnp.ones((batch,), jnp.float32)
    acc = [state["zero_acc"](), jnp.zeros(())]

    def one():
        acc[0], acc[1] = flow_step(em_p, g_p, acc[0], acc[1], x, w)
        return acc[1]

    best = _timed(one, iters)
    em_p, g_p = em_update(em_p, g_p, acc[0], jnp.float32(1.0))  # sanity: runs
    assert np.isfinite(float(jnp.sum(next(iter(em_p.values())))))
    return best * 1e3


def bench_serving(sum_product: str, num_units: int, iters: int):
    """Serving-scale forward: batch sweep x {f32 weight store, bf16 weight
    store}, with samples/s and useful TFLOP/s (single-pass contraction
    math, :func:`_fwd_gflops_per_sample`)."""
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.serving import bf16_weight_store
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    batches = [int(b) for b in os.environ.get("BENCH_SERVING_BATCHES", "512,2048").split(",")]
    sc = image_data(
        (1, 28, 28),
        "quad-graph",
        input_layer="categorical",
        num_input_units=num_units,
        sum_product_layer=sum_product,
        num_sum_units=num_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    gflops = _fwd_gflops_per_sample(cc)
    fwd = jax.jit(lambda st, xx: cc.evaluate(st, xx))
    rows = []
    for mode in ("f32_store", "bf16_store"):
        store = cc.restrict_store(ctx.parameters)
        if mode == "bf16_store":
            store = bf16_weight_store(cc, store)
        for batch in batches:
            x = jnp.asarray(
                np.random.default_rng(0).integers(0, 256, size=(batch, 784), dtype=np.int32)
            )
            best = _timed(lambda: fwd(store, x), max(2, int(iters * 128 / batch)))
            sps = batch / best
            rows.append(
                {
                    "mode": mode,
                    "batch": batch,
                    "samples_per_sec": round(sps, 1),
                    "batch_ms": round(best * 1e3, 3),
                    "useful_tflops": round(sps * gflops / 1e3, 2),
                }
            )
    return rows


def bench_structure(sum_product: str, num_units: int) -> dict:
    """Structure-search timings: flagship prune_circuit end-to-end and a
    mid-size grow_prune_loop round."""
    from cirkit_tpu.backend.jax.pruning import grow_prune_loop, prune_circuit
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    out = {}
    # mid-size loop: (1, 8, 8) categorical, one grow+prune round with EM
    sc = image_data(
        (1, 8, 8), "quad-graph", input_layer="categorical",
        num_input_units=16, sum_product_layer=sum_product, num_sum_units=16,
        em_ready=True,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(512, 64), dtype=np.int32)
    t0 = time.time()
    _, _, history = grow_prune_loop(
        sc, data, ctx=ctx, rounds=1, grow_fraction=0.25, prune_fraction=0.25,
        em_epochs=2, batch_size=256,
    )
    out["grow_prune_loop_midsize_s"] = round(time.time() - t0, 1)
    out["grow_prune_loop_stages"] = len(history)

    sc = image_data(
        (1, 28, 28), "quad-graph", input_layer="categorical",
        num_input_units=num_units, sum_product_layer=sum_product,
        num_sum_units=num_units, em_ready=True,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    ctx.compile(sc)
    t0 = time.time()
    _, rep = prune_circuit(sc, ctx=ctx, fraction=0.5)
    out["prune_flagship_s"] = round(time.time() - t0, 1)
    out["prune_flagship_units"] = [rep["units_before"], rep["units_after"]]
    return out


def bench_warm_save(sum_product: str, num_units: int, batch: int) -> dict:
    """Save the flagship's AOT warm-start bundle to ``BENCH_TMP/bundle``,
    for the ``warm_load`` section to time in a fresh process."""
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.warmstart import save_bundle
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, 28, 28),
        "quad-graph",
        input_layer="categorical",
        num_input_units=num_units,
        sum_product_layer=sum_product,
        num_sum_units=num_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    t0 = time.time()
    save_bundle(
        os.path.join(os.environ["BENCH_TMP"], "bundle"), cc,
        store=dict(ctx.parameters), batch=batch, x_dtype=jnp.int32,
    )
    return {"bundle_save_s": round(time.time() - t0, 1)}


def bench_warm_load(batch: int) -> dict:
    """Time-to-first-batch through the warm-start bundle in this fresh
    process: load, draw the store on device, run and sync one batch. The
    reference's corresponding figure is its symbolic build + torch compile
    of this circuit, ~5.4-5.7 s (BASELINE.md, imports excluded, as here)."""
    import jax

    from cirkit_tpu.backend.jax.warmstart import load_bundle

    t0 = time.time()
    b = load_bundle(os.path.join(os.environ["BENCH_TMP"], "bundle"))
    load_s = time.time() - t0
    t0 = time.time()
    store = b.init(0)
    x = jax.device_put(np.random.default_rng(0).integers(0, 256, (batch, 784)).astype(np.int32))
    out = np.asarray(jax.block_until_ready(b.evaluate(store, x)))
    first_s = time.time() - t0
    assert np.isfinite(out).all()
    return {
        "warm_load_s": round(load_s, 2),
        "warm_init_plus_first_batch_s": round(first_s, 2),
        "time_to_first_batch_warm_s": round(load_s + first_s, 2),
    }


def bench_qpc(sum_product: str, num_units: int, batch: int, iters: int) -> dict:
    """QPC (quadrature PC, the reference's PIC) at the flagship config:
    pc2qpc-convert the MNIST QuadGraph circuit and time a full jitted
    training step — generator nets -> materialized store -> forward ->
    backward through the nets -> adam. The reference's PIC notebook is one
    of its headline results (bpd 1.189 vs 1.255, BASELINE.md); this pins
    that the functional-generator redesign holds at flagship scale."""
    import jax
    import jax.numpy as jnp
    import optax

    from cirkit_tpu.backend.jax.pic import pc2qpc
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, 28, 28), "quad-graph", input_layer="categorical",
        num_input_units=num_units, sum_product_layer=sum_product,
        num_sum_units=num_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    t0 = time.time()
    qpc, qp = pc2qpc(
        cc, dict(ctx.parameters), integration_method="leggauss",
        key=jax.random.PRNGKey(0), net_dim=64,
    )
    convert_s = time.time() - t0
    opt = optax.adam(5e-3)
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, size=(batch, 784), dtype=np.int32)
    )

    def step(params, opt_state, xx):
        def loss_fn(p):
            store = qp.materialize(p)
            return -jnp.mean(qpc.evaluate(store, xx)[:, 0, 0])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state = qp.net_params, opt.init(qp.net_params)
    t0 = time.time()
    lowered = jax.jit(step, donate_argnums=(0, 1)).lower(params, opt_state, x)
    lower_s = time.time() - t0
    t0 = time.time()
    jstep = lowered.compile()
    compile_s = time.time() - t0
    t0 = time.time()
    params, opt_state, loss = jax.block_until_ready(jstep(params, opt_state, x))
    first_step_s = time.time() - t0
    assert np.isfinite(float(loss)), float(loss)
    state = [params, opt_state]

    def one():
        state[0], state[1], loss = jstep(state[0], state[1], x)
        return loss

    best = _timed(one, max(iters // 4, 3))
    ma = jstep.memory_analysis()
    return {
        "qpc_step_ms": round(best * 1e3, 2),
        "qpc_convert_s": round(convert_s, 1),
        "qpc_lower_s": round(lower_s, 1),
        "qpc_compile_s": round(compile_s, 1),
        "qpc_first_step_s": round(first_step_s, 2),
        "qpc_temp_bytes": None if ma is None else int(ma.temp_size_in_bytes),
        "qpc_samples_per_sec": round(batch / best, 1),
    }


def bench_k128(iters: int = 20) -> dict:
    """The K=128 Tucker contraction alone (255 folds, O=128, K1*K2=16384,
    batch 128) through ``lse_tucker2_softmax``. Inputs are drawn on
    device."""
    import jax

    from cirkit_tpu.ops import lse_einsum as L

    F, B, K, O = 255, 128, 128, 128
    make = jax.jit(
        lambda k: (
            jax.random.normal(k, (F, B, K)) - 3.0,
            jax.random.normal(jax.random.fold_in(k, 1), (F, B, K)) - 3.0,
            jax.random.normal(jax.random.fold_in(k, 2), (F, O, K * K)),
        )
    )
    x1, x2, th = jax.block_until_ready(make(jax.random.PRNGKey(7)))
    f = jax.jit(L.lse_tucker2_softmax)
    assert np.isfinite(np.asarray(f(x1, x2, th))).all()
    return {"k128_fwd_ms": round(_timed(lambda: f(x1, x2, th), max(iters // 4, 2)) * 1e3, 3)}


def bench_autocache(sum_product: str, num_units: int, batch: int) -> dict:
    """Time-to-first-batch of plain user code (image_data -> ctx.compile ->
    cc(x)) in this fresh process with the warm-compile cache
    (backend/jax/warmcache.py) at ``BENCH_TMP/autocache``: the first such
    section populates it, the second reads it."""
    t0 = time.time()
    os.environ["CIRKIT_TPU_CACHE"] = os.path.join(os.environ["BENCH_TMP"], "autocache")
    from cirkit_tpu.backend.jax import warmcache
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, 28, 28), "quad-graph", input_layer="categorical",
        num_input_units=num_units, sum_product_layer=sum_product, num_sum_units=num_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    x = np.random.default_rng(0).integers(0, 256, (batch, 784)).astype(np.int32)
    out = np.asarray(cc(x))
    assert np.isfinite(out).all()
    return {"wall_s": round(time.time() - t0, 2), "stats": dict(warmcache.stats)}


def _config():
    return dict(
        sum_product=os.environ.get("BENCH_SUM_PRODUCT", "tucker"),
        num_units=int(os.environ.get("BENCH_UNITS", "64")),
        batch=int(os.environ.get("BENCH_BATCH", "128")),
        iters=int(os.environ.get("BENCH_ITERS", "50")),
        optimize=os.environ.get("BENCH_OPTIMIZE", "1") == "1",
    )


def _fwd(c) -> dict:
    sps, per_batch, build_s, compile_s = bench_config(
        c["sum_product"], c["num_units"], c["batch"], c["iters"], c["optimize"]
    )
    return {
        "metric": f"mnist_quadgraph_{c['sum_product']}_k{c['num_units']}_folded_fwd",
        "value": round(sps, 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(sps / BASELINE_SAMPLES_PER_SEC, 3),
        "vs_baseline_folded_only": round(sps / BASELINE_FOLDED_SAMPLES_PER_SEC, 3),
        "batch_ms": round(per_batch * 1e3, 3),
        "trace_build_s": round(build_s, 1),
        "jit_compile_s": round(compile_s, 1),
        "time_to_first_batch_cold_s": round(build_s + compile_s, 1),
    }


def _cp_fwd(c) -> dict:
    sps, per_batch, _, _ = bench_config("cp", c["num_units"], c["batch"], c["iters"], c["optimize"])
    return {"cp_samples_per_sec": round(sps, 1), "cp_batch_ms": round(per_batch * 1e3, 3)}


def _train(c, sum_product: str, batch: int, lowmem: bool = False) -> dict:
    sps, step_s = bench_train(
        sum_product, c["num_units"], batch, max(c["iters"] // 5, 5), c["optimize"], lowmem=lowmem
    )
    tag = f"train_{sum_product}" + ("_lowmem" if lowmem else "")
    return {f"{tag}_samples_per_sec": round(sps, 1), f"{tag}_step_ms": round(step_s * 1e3, 3)}


def _sos(c) -> dict:
    sps, sec = bench_sos(batch=c["batch"], iters=c["iters"])
    return {"sos_signed_samples_per_sec": round(sps, 1), "sos_signed_batch_ms": round(sec * 1e3, 3)}


def _autocache(tag: str):
    def run(c) -> dict:
        r = bench_autocache(c["sum_product"], c["num_units"], c["batch"])
        return {f"time_to_first_batch_{tag}_s": r["wall_s"], f"autocache_{tag}_stats": r["stats"]}

    return run


# name -> section, run in this order, each in a fresh child process
SECTIONS = {
    "fwd": _fwd,
    "cp_fwd": _cp_fwd,
    "warm_save": lambda c: bench_warm_save(c["sum_product"], c["num_units"], c["batch"]),
    "warm_load": lambda c: bench_warm_load(c["batch"]),
    "autocache_miss": _autocache("cachemiss"),
    "autocache_hit": _autocache("cached"),
    "k128": lambda c: bench_k128(),
    "qpc": lambda c: bench_qpc(c["sum_product"], c["num_units"], c["batch"], c["iters"]),
    "train": lambda c: _train(c, c["sum_product"], c["batch"]),
    "train_lowmem": lambda c: _train(c, c["sum_product"], c["batch"], lowmem=True),
    "train_cp": lambda c: _train(c, "cp", 256),
    "sos": _sos,
    "em": lambda c: {"em_step_ms": round(
        bench_em(c["sum_product"], c["num_units"], c["batch"], max(c["iters"] // 5, 5)), 3
    )},
    "queries": lambda c: bench_queries(c["sum_product"], c["num_units"], c["batch"], c["iters"]),
    "serving": lambda c: {"serving": bench_serving(c["sum_product"], c["num_units"], c["iters"])},
    "structure": lambda c: bench_structure(c["sum_product"], c["num_units"]),
}
# a section that runs longer is killed and reported as failed
SECTION_TIMEOUT_S = 900


def run_section(name: str) -> dict:
    """Run one section in this process, on the GPU only."""
    from chip_smoke import gpu_name_and_power, require_gpu, use_compile_cache

    use_compile_cache()
    dev = require_gpu()
    out = SECTIONS[name](_config())
    return {
        "section": name,
        **out,
        "device": dev,
        "card": gpu_name_and_power(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def main(argv: list[str]) -> int:
    names = argv or list(SECTIONS)
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        print(f"unknown sections {unknown}; known: {list(SECTIONS)}", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="cirkit_bench_")
    env = {**os.environ, "BENCH_TMP": tmp}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.pop("CIRKIT_TPU_CACHE", None)  # cold numbers stay cold
    merged: dict = {}
    failed = []
    try:
        for name in names:
            t0 = time.time()
            try:
                proc = subprocess.run(
                    [sys.executable, os.path.join(REPO, "bench.py"), "--section", name],
                    cwd=REPO, env=env, capture_output=True, text=True,
                    timeout=SECTION_TIMEOUT_S,
                )
            except subprocess.TimeoutExpired:
                failed.append(name)
                print(json.dumps({"section": name, "error": "timeout"}), flush=True)
                continue
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                failed.append(name)
                sys.stderr.write(proc.stderr[-4000:])
                print(json.dumps({"section": name, "error": proc.returncode}), flush=True)
                continue
            result = json.loads(lines[-1])
            result["section_wall_s"] = round(time.time() - t0, 1)
            print(json.dumps(result), flush=True)
            merged.update({k: v for k, v in result.items() if k != "section"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    merged.pop("section_wall_s", None)
    merged["failed_sections"] = failed
    print(json.dumps(merged), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--section"]:
        print(json.dumps(run_section(sys.argv[2])), flush=True)
    else:
        sys.exit(main(sys.argv[1:]))
