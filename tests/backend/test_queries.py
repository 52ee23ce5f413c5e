"""Query tests: IntegrateQuery matches the compiled integral circuit, with
batched/broadcast per-sample scopes and error cases; SamplingQuery's sampled
world frequencies match the true distribution (ref:
``tests/backend/torch/test_queries/``)."""

import collections

import jax
import numpy as np
import pytest

from cirkit_tpu.backend.jax.queries import IntegrateQuery, SamplingQuery
from cirkit_tpu.pipeline import PipelineContext
from cirkit_tpu.utils import Scope

from tests.fixtures import build_bivariate_categorical_pc, build_multivariate_categorical_pc
from tests.reference_eval import enumerate_worlds, eval_circuit


@pytest.mark.parametrize("fold", [False, True])
def test_integrate_query_equals_integral_circuit(fold):
    ctx = PipelineContext(semiring="lse-sum", fold=fold)
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(20))
    cc = ctx.compile(sc)
    query = IntegrateQuery(cc)
    worlds = enumerate_worlds(4, 2)
    # marginalize vars {1, 3} for every sample
    got = np.asarray(query(worlds, integrate_vars=Scope([1, 3])))
    full = eval_circuit(sc, worlds)[:, 0, 0].reshape(2, 2, 2, 2)
    marg = full.sum(axis=(1, 3))  # (2, 2) over vars 0, 2
    want = np.log(marg[worlds[:, 0], worlds[:, 2]])
    np.testing.assert_allclose(got[:, 0, 0], want, rtol=1e-9)


def test_integrate_query_batched_scopes():
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(21))
    cc = ctx.compile(sc)
    query = IntegrateQuery(cc)
    x = np.array([[0, 1, 0, 1], [1, 0, 1, 0], [0, 0, 1, 1]])
    scopes = [Scope([0]), Scope([1, 2]), Scope([])]
    got = np.asarray(query(x, integrate_vars=scopes))[:, 0, 0]
    worlds = enumerate_worlds(4, 2)
    full = eval_circuit(sc, worlds)[:, 0, 0].reshape(2, 2, 2, 2)
    want = [
        np.log(full[:, x[0, 1], x[0, 2], x[0, 3]].sum()),
        np.log(full[x[1, 0], :, :, x[1, 3]].sum()),
        np.log(full[tuple(x[2])]),
    ]
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_integrate_query_boolean_mask_and_broadcast():
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(22))
    cc = ctx.compile(sc)
    query = IntegrateQuery(cc)
    x = enumerate_worlds(4, 2)
    mask = np.zeros(4, dtype=bool)
    mask[2] = True
    got = np.asarray(query(x, integrate_vars=mask))[:, 0, 0]
    got_scope = np.asarray(query(x, integrate_vars=Scope([2])))[:, 0, 0]
    np.testing.assert_allclose(got, got_scope, rtol=1e-12)
    # full-scope mask equals the partition function everywhere
    full_mask = np.ones((1, 4), dtype=bool)
    z = np.asarray(query(x, integrate_vars=full_mask))[:, 0, 0]
    worlds = enumerate_worlds(4, 2)
    z_true = np.log(eval_circuit(sc, worlds)[:, 0, 0].sum())
    np.testing.assert_allclose(z, z_true, rtol=1e-9)


def test_integrate_query_errors():
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(23))
    cc = ctx.compile(sc)
    query = IntegrateQuery(cc)
    x = enumerate_worlds(4, 2)
    with pytest.raises(ValueError, match="subset"):
        query(x, integrate_vars=Scope([7]))
    with pytest.raises(ValueError, match="batch size"):
        query(x, integrate_vars=[Scope([0]), Scope([1])])
    with pytest.raises(ValueError, match="boolean"):
        query(x, integrate_vars=np.zeros((1, 4), dtype=np.int32))
    with pytest.raises(ValueError, match="variables"):
        query(x, integrate_vars=np.zeros((1, 7), dtype=bool))


@pytest.mark.parametrize("fold", [False, True])
def test_sampling_frequencies_match_distribution(fold):
    # normalized PC: softmax-ish probs with convex sum weights
    rng = np.random.default_rng(24)
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from tests.fixtures import const_param

    layers = []
    for v in range(2):
        raw = rng.uniform(0.1, 1.0, (2, 2))
        probs = raw / raw.sum(axis=1, keepdims=True)
        layers.append(
            CategoricalLayer(Scope([v]), 2, num_categories=2, probs=const_param(probs))
        )
    h = HadamardLayer(2, arity=2)
    w = rng.uniform(0.1, 1.0, (1, 2))
    s = SumLayer(2, 1, weight=const_param(w / w.sum()))
    sc = Circuit(layers + [h, s], {h: layers, s: [h]}, [s])

    ctx = PipelineContext(semiring="lse-sum", fold=fold)
    cc = ctx.compile(sc)
    query = SamplingQuery(cc)
    n = 20000
    samples, mixtures = query(n, key=jax.random.PRNGKey(0))
    samples = np.asarray(samples).astype(int)
    assert samples.shape == (n, 2)
    counts = collections.Counter(map(tuple, samples.tolist()))
    worlds = enumerate_worlds(2, 2)
    probs = eval_circuit(sc, worlds)[:, 0, 0]
    probs = probs / probs.sum()
    for world, p in zip(map(tuple, worlds.tolist()), probs):
        freq = counts.get(world, 0) / n
        assert abs(freq - p) < 0.02, (world, freq, p)
    assert len(mixtures) >= 1  # the root sum layer's latent choices


def test_sampling_requires_positive_samples():
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    sc = build_bivariate_categorical_pc(rng=np.random.default_rng(25))
    cc = ctx.compile(sc)
    with pytest.raises(ValueError, match="positive"):
        SamplingQuery(cc)(0)


def test_sampling_from_optimized_tucker_circuit():
    """Ancestral sampling through fused Tucker layers (the optimizer's
    rewrite of sum-of-Kronecker); frequencies must match the density. An
    extension: the reference's Tucker layer cannot sample."""
    rng = np.random.default_rng(31)
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, KroneckerLayer, SumLayer
    from tests.fixtures import const_param

    layers = []
    for v in range(2):
        raw = rng.uniform(0.1, 1.0, (2, 2))
        layers.append(
            CategoricalLayer(
                Scope([v]), 2, num_categories=2,
                probs=const_param(raw / raw.sum(axis=1, keepdims=True)),
            )
        )
    k = KroneckerLayer(2, arity=2)
    w = rng.uniform(0.1, 1.0, (1, 4))
    s = SumLayer(4, 1, weight=const_param(w / w.sum()))
    sc = Circuit(layers + [k, s], {k: layers, s: [k]}, [s])

    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    from cirkit_tpu.backend.jax.optimized import JaxTuckerLayer

    assert any(isinstance(l, JaxTuckerLayer) for l in cc.layers)
    n = 20000
    samples, mixtures = SamplingQuery(cc)(n, key=jax.random.PRNGKey(1))
    samples = np.asarray(samples).astype(int)
    counts = collections.Counter(map(tuple, samples.tolist()))
    worlds = enumerate_worlds(2, 2)
    probs = eval_circuit(sc, worlds)[:, 0, 0]
    probs = probs / probs.sum()
    for world, p in zip(map(tuple, worlds.tolist()), probs):
        assert abs(counts.get(world, 0) / n - p) < 0.02
    assert len(mixtures) >= 1


def test_query_jits_are_cached_on_the_circuit():
    """Fresh query objects over the same circuit reuse the traced program —
    no recompile per IntegrateQuery(cc)/SamplingQuery(cc) (VERDICT r1 #6)."""
    sc = build_bivariate_categorical_pc(rng=np.random.default_rng(40))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    worlds = enumerate_worlds(2, 3)

    q1 = IntegrateQuery(cc)
    out1 = q1(worlds, integrate_vars=Scope([0]))
    q2 = IntegrateQuery(cc)
    out2 = q2(worlds, integrate_vars=Scope([0]))
    assert getattr(cc, "_integrate_jit") is not None
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2))

    s1 = SamplingQuery(cc)
    s1(5, key=jax.random.PRNGKey(0))
    s2 = SamplingQuery(cc)
    s2(5, key=jax.random.PRNGKey(0))
    # lse-sum circuits route through the shared two-pass program, cached on
    # the circuit per (kind, root) — and reused verbatim by conditional
    # sampling at the same root head
    fn = cc._routing_jits[("sample", 0, 0, None, "model", "data")]
    assert fn is not None
    s2.conditional(
        worlds[:5], evidence_mask=np.ones((5, 2), dtype=bool),
        key=jax.random.PRNGKey(1),
    )
    assert (
        cc._routing_jits[("sample", 0, 0, None, "model", "data")] is fn
        and len(cc._routing_jits) == 1
    )


def test_conditional_sampling_matches_posterior_frequencies():
    """Posterior completion sampling (the reference documents conditional
    sampling as not implemented): empirical frequencies of the sampled free
    variables must match p(x_free | x_obs) from exhaustive enumeration, and
    the returned value must be log p(x_obs)."""
    import jax.numpy as jnp

    ctx = PipelineContext(semiring="lse-sum", fold=True)
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(50))
    cc = ctx.compile(sc)
    query = SamplingQuery(cc)

    n = 6000
    x = np.zeros((n, 4), dtype=np.int64)
    x[:, 0] = 1  # evidence: first variable pinned to state 1
    mask = np.zeros((4,), dtype=bool)
    mask[0] = True
    samples, log_ev = query.conditional(
        jnp.asarray(x), evidence_mask=jnp.asarray(mask),
        key=jax.random.PRNGKey(0), store=ctx.parameters,
    )
    samples = np.asarray(samples).astype(int)
    assert (samples[:, 0] == 1).all()

    worlds = enumerate_worlds(4, 2)
    joint = eval_circuit(sc, worlds)[:, 0, 0]
    keep = worlds[:, 0] == 1
    post = joint[keep] / joint[keep].sum()
    np.testing.assert_allclose(
        np.asarray(log_ev), np.log(joint[keep].sum()), rtol=1e-6
    )

    free_worlds = worlds[keep][:, 1:]
    counts = collections.Counter(map(tuple, samples[:, 1:]))
    freqs = np.array([counts.get(tuple(w), 0) / n for w in free_worlds])
    # 4-sigma binomial tolerance per world
    tol = 4 * np.sqrt(post * (1 - post) / n)
    assert (np.abs(freqs - post) <= tol + 1e-3).all(), (freqs, post)


def test_conditional_sampling_full_evidence_returns_input():
    import jax.numpy as jnp

    ctx = PipelineContext(semiring="lse-sum", fold=True)
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(51))
    cc = ctx.compile(sc)
    worlds = enumerate_worlds(4, 2)
    samples, vals = SamplingQuery(cc).conditional(
        jnp.asarray(worlds), evidence_mask=np.ones((len(worlds), 4), dtype=bool),
        key=jax.random.PRNGKey(1), store=ctx.parameters,
    )
    np.testing.assert_array_equal(np.asarray(samples).astype(int), worlds)
    want = np.log(eval_circuit(sc, worlds)[:, 0, 0])
    np.testing.assert_allclose(np.asarray(vals), want, rtol=1e-6)


@pytest.mark.slow
def test_conditional_sampling_on_optimized_circuit_runs():
    """Folded+optimized (Tucker-fused) circuits route conditional draws
    through the fused layers; observed entries round-trip."""
    import jax.numpy as jnp

    from cirkit_tpu.models import image_data

    sc = image_data(
        (1, 4, 4), "quad-graph", input_layer="categorical",
        num_input_units=3, sum_product_layer="tucker", num_sum_units=3,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=6)
    cc = ctx.compile(sc)
    rng = np.random.default_rng(52)
    x = rng.integers(0, 256, size=(5, 16))
    mask = rng.random((5, 16)) < 0.5
    samples, log_ev = SamplingQuery(cc).conditional(
        jnp.asarray(x), evidence_mask=jnp.asarray(mask),
        key=jax.random.PRNGKey(2), store=ctx.parameters,
    )
    samples = np.asarray(samples)
    np.testing.assert_array_equal(samples[mask].astype(int), x[mask])
    assert ((samples >= 0) & (samples <= 255)).all()
    assert np.isfinite(np.asarray(log_ev)).all()


def test_conditional_sampling_gaussian_posterior_moments():
    """Continuous evidence: observing x0 reweights the mixture; sampled x1
    moments must match the posterior mixture moments."""
    import jax.numpy as jnp
    from scipy.stats import norm

    from tests.fixtures import build_bivariate_gaussian_pc
    from tests.reference_eval import eval_parameter

    sc = build_bivariate_gaussian_pc(num_units=3, rng=np.random.default_rng(60))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)

    x0 = 0.7
    n = 8000
    x = np.zeros((n, 2))
    x[:, 0] = x0
    mask = np.array([True, False])
    samples, log_ev = SamplingQuery(cc).conditional(
        jnp.asarray(x), evidence_mask=jnp.asarray(mask),
        key=jax.random.PRNGKey(3), store=ctx.parameters,
    )
    draws = np.asarray(samples)[:, 1]

    layers = list(sc.topological_ordering())
    mu = np.stack([eval_parameter(l.mean) for l in layers[:2]])  # (2, K)
    sd = np.stack([eval_parameter(l.stddev) for l in layers[:2]])
    w = eval_parameter(sc.outputs[0].weight)[0]
    # posterior over components given x0
    lik0 = norm.pdf(x0, mu[0], sd[0])
    post = w * lik0 / (w * lik0).sum()
    mean_want = (post * mu[1]).sum()
    var_want = (post * (sd[1] ** 2 + mu[1] ** 2)).sum() - mean_want**2
    np.testing.assert_allclose(draws.mean(), mean_want, atol=4 * np.sqrt(var_want / n))
    np.testing.assert_allclose(draws.var(), var_want, rtol=0.1)
    np.testing.assert_allclose(
        np.asarray(log_ev)[0], np.log((w * lik0).sum()), rtol=1e-6
    )


def test_sampling_frequencies_with_wide_mixture_axis():
    """A wide composite mixture axis (M=1024 through a fused Tucker layer):
    world frequencies must match the density exactly."""
    rng = np.random.default_rng(70)
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, KroneckerLayer, SumLayer
    from tests.fixtures import const_param

    k = 32
    layers = []
    for v in range(2):
        raw = rng.uniform(0.1, 1.0, (k, 3))
        layers.append(
            CategoricalLayer(
                Scope([v]), k, num_categories=3,
                probs=const_param(raw / raw.sum(axis=1, keepdims=True)),
            )
        )
    kr = KroneckerLayer(k, arity=2)
    w = rng.uniform(0.1, 1.0, (1, k * k))
    s = SumLayer(k * k, 1, weight=const_param(w / w.sum()))
    sc = Circuit(layers + [kr, s], {kr: layers, s: [kr]}, [s])

    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    n = 20000
    samples, _ = SamplingQuery(cc)(n, key=jax.random.PRNGKey(7), store=ctx.parameters)
    samples = np.asarray(samples).astype(int)
    counts = collections.Counter(map(tuple, samples.tolist()))
    worlds = enumerate_worlds(2, 3)
    probs = eval_circuit(sc, worlds)[:, 0, 0]
    probs = probs / probs.sum()
    for world, p in zip(map(tuple, worlds.tolist()), probs):
        freq = counts.get(world, 0) / n
        assert abs(freq - p) < 4 * np.sqrt(p * (1 - p) / n) + 1e-3, (world, freq, p)


def test_sampling_sum_product_semiring_uses_dense_path():
    """Non-lse circuits keep the padded bottom-up sampler; frequencies must
    still match the density."""
    rng = np.random.default_rng(71)
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from tests.fixtures import const_param

    layers = []
    for v in range(2):
        raw = rng.uniform(0.1, 1.0, (2, 2))
        layers.append(
            CategoricalLayer(
                Scope([v]), 2, num_categories=2,
                probs=const_param(raw / raw.sum(axis=1, keepdims=True)),
            )
        )
    h = HadamardLayer(2, arity=2)
    w = rng.uniform(0.1, 1.0, (1, 2))
    s = SumLayer(2, 1, weight=const_param(w / w.sum()))
    sc = Circuit(layers + [h, s], {h: layers, s: [h]}, [s])

    ctx = PipelineContext(semiring="sum-product", fold=True)
    cc = ctx.compile(sc)
    n = 20000
    samples, mixtures = SamplingQuery(cc)(n, key=jax.random.PRNGKey(8), store=ctx.parameters)
    samples = np.asarray(samples).astype(int)
    counts = collections.Counter(map(tuple, samples.tolist()))
    worlds = enumerate_worlds(2, 2)
    probs = eval_circuit(sc, worlds)[:, 0, 0]
    probs = probs / probs.sum()
    for world, p in zip(map(tuple, worlds.tolist()), probs):
        assert abs(counts.get(world, 0) / n - p) < 0.02, (world, p)
    assert len(mixtures) >= 1


@pytest.mark.slow
def test_sample_selected_with_zero_probability_category():
    """A zero-probability category in ANY unit must not corrupt other
    units' draws through the one-hot selection matmul (0 * -inf = NaN;
    regression: category 2's ~0.25 posterior was drawn at ~0.003)."""
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.layers import JaxCategoricalLayer
    from cirkit_tpu.models import tabular_data

    sc = tabular_data(
        "random-binary-tree", num_features=2,
        input_layers={"name": "categorical", "args": {"num_categories": 3}},
        num_input_units=2, sum_product_layer="cp", num_sum_units=2,
        em_ready=True,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, seed=21)
    cc = ctx.compile(sc)
    store = dict(cc.restrict_store(ctx.parameters))
    # zero out one category of one unit in every categorical leaf slot
    for layer in cc.layers:
        if isinstance(layer, JaxCategoricalLayer) and layer.probs is not None:
            for node in layer.probs.topological_ordering():
                slot = getattr(node, "slot", None)
                if slot is not None and slot in store:
                    p = np.array(store[slot])
                    p[..., 0, 0] = 0.0
                    p /= p.sum(axis=-1, keepdims=True)
                    store[slot] = jnp.asarray(p)
    # true marginals by enumeration
    worlds = np.array([[a, b] for a in range(3) for b in range(3)], np.int64)
    lw = np.asarray(cc.jit_evaluate(store, jnp.asarray(worlds)))[:, 0, 0]
    p = np.exp(lw - np.logaddexp.reduce(lw))
    n = 4000
    samples, _ = SamplingQuery(cc)(n, key=jax.random.PRNGKey(3), store=store)
    s = np.asarray(samples).astype(int)
    freq = np.zeros(len(worlds))
    for i, w in enumerate(worlds):
        freq[i] = np.mean((s == w).all(axis=1))
    assert not np.isnan(freq).any()
    np.testing.assert_allclose(freq, p, atol=0.04)


@pytest.mark.slow
def test_conditional_sampling_accepts_rbg_key():
    """A typed rbg key (4-word key data) is a legitimate key argument and
    must not crash the 2-word tile conversion (regression)."""
    sc = build_bivariate_categorical_pc(rng=np.random.default_rng(48))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    worlds = enumerate_worlds(2, 3)
    q = SamplingQuery(cc)
    for key in (
        jax.random.key(0, impl="rbg"),
        jax.random.key(0, impl="threefry2x32"),
        jax.random.PRNGKey(0),
    ):
        s, le = q.conditional(
            worlds[:4], evidence_mask=np.ones((4, 2), dtype=bool),
            key=key, store=ctx.parameters,
        )
        assert np.isfinite(np.asarray(le)).all()


def test_expectation_query_matches_enumeration():
    """E[x_v | x_obs] by one backward pass must equal the exhaustive
    posterior expectation over consistent worlds."""
    from cirkit_tpu.backend.jax.queries import ExpectationQuery

    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(90))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)
    x = np.zeros((2, 4), dtype=np.int64)
    x[:, 0] = [0, 1]
    mask = np.zeros((2, 4), dtype=bool)
    mask[:, 0] = True
    got = np.asarray(q(x, evidence_mask=mask, store=ctx.parameters))

    worlds = enumerate_worlds(4, 2)
    p = eval_circuit(sc, worlds)[:, 0, 0]
    for b in range(2):
        keep = worlds[:, 0] == x[b, 0]
        pw = p[keep] / p[keep].sum()
        want = (pw[:, None] * worlds[keep]).sum(axis=0)
        want[0] = x[b, 0]
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-9)


def test_expectation_query_gaussian_posterior_mean():
    """1-D GMM: the posterior mean given NO evidence is the prior mixture
    mean; given a second correlated variable it matches the closed form."""
    from scipy.stats import norm

    from cirkit_tpu.backend.jax.queries import ExpectationQuery
    from cirkit_tpu.symbolic import Circuit, GaussianLayer, HadamardLayer, SumLayer
    from tests.fixtures import const_param

    rng = np.random.default_rng(91)
    k = 3
    mus = rng.normal(scale=2.0, size=(2, k))
    sds = rng.uniform(0.5, 1.2, size=(2, k))
    leaves = [
        GaussianLayer(Scope([v]), k, mean=const_param(mus[v]), stddev=const_param(sds[v]))
        for v in range(2)
    ]
    prod = HadamardLayer(k, arity=2)
    w = rng.dirichlet(np.ones(k))
    root = SumLayer(k, 1, weight=const_param(w[None]))
    sc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)

    x = np.array([[0.7, 0.0], [-1.5, 0.0]], dtype=np.float64)
    mask = np.array([[True, False]] * 2)
    got = np.asarray(q(x, evidence_mask=mask, store=ctx.parameters))
    for b in range(2):
        like = np.array([norm.pdf(x[b, 0], mus[0, c], sds[0, c]) for c in range(k)])
        r = w * like / (w * like).sum()
        want1 = (r * mus[1]).sum()
        np.testing.assert_allclose(got[b, 1], want1, rtol=1e-6)
        np.testing.assert_allclose(got[b, 0], x[b, 0], rtol=1e-12)


@pytest.mark.slow
def test_expectation_query_on_optimized_image_circuit():
    """Soft imputation runs through fused Tucker circuits and respects the
    evidence; free entries land inside the state range."""
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.queries import ExpectationQuery
    from cirkit_tpu.models import image_data

    sc = image_data(
        (1, 4, 4), "quad-tree-2", input_layer="categorical",
        num_input_units=8, sum_product_layer="tucker", num_sum_units=8,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=14)
    cc = ctx.compile(sc)
    rng = np.random.default_rng(92)
    x = jnp.asarray(rng.integers(0, 256, size=(5, 16)), jnp.int32)
    mask = rng.random((5, 16)) < 0.5
    q = ExpectationQuery(cc)
    got = np.asarray(q(x, evidence_mask=jnp.asarray(mask), store=ctx.parameters))
    assert np.array_equal(got[mask], np.asarray(x)[mask])
    free = got[~mask]
    assert np.isfinite(free).all() and (free >= 0).all() and (free <= 255).all()

    # variance and full marginals ride the same responsibilities: the
    # marginal rows are distributions whose mean/variance reproduce them
    mean, var = q(
        x, evidence_mask=jnp.asarray(mask), store=ctx.parameters, return_variance=True
    )
    marg = np.asarray(q.marginals(x, evidence_mask=jnp.asarray(mask), store=ctx.parameters))
    assert marg.shape == (5, 16, 256)
    np.testing.assert_allclose(marg.sum(axis=2), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(mean), got, rtol=1e-6)
    s = np.arange(256.0)
    m1 = (marg * s).sum(axis=2)
    m2 = (marg * s**2).sum(axis=2)
    np.testing.assert_allclose(m1[~mask], got[~mask], rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(var)[~mask], (m2 - m1**2)[~mask], rtol=1e-3, atol=1e-3
    )
    assert (np.asarray(var)[mask] == 0).all()


def test_expectation_query_rejects_wrong_mask_width():
    from cirkit_tpu.backend.jax.queries import ExpectationQuery

    sc = build_bivariate_categorical_pc(rng=np.random.default_rng(93))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)
    x = np.zeros((2, 2), dtype=np.int64)
    with pytest.raises(ValueError, match="variables"):
        q(x, evidence_mask=np.zeros((2, 5), dtype=bool), store=ctx.parameters)


def test_posterior_marginals_match_enumeration():
    """marginals(): every p(x_v = s | x_obs) in one backward pass must
    equal the exhaustive posterior; rows are distributions; observed
    variables come back one-hot; the implied mean equals __call__."""
    from cirkit_tpu.backend.jax.queries import ExpectationQuery

    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(94))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)
    x = np.zeros((2, 4), dtype=np.int64)
    x[:, 0] = [0, 1]
    mask = np.zeros((2, 4), dtype=bool)
    mask[:, 0] = True
    got = np.asarray(q.marginals(x, evidence_mask=mask, store=ctx.parameters))
    assert got.shape == (2, 4, 2)
    np.testing.assert_allclose(got.sum(axis=2), 1.0, rtol=1e-6)

    worlds = enumerate_worlds(4, 2)
    p = eval_circuit(sc, worlds)[:, 0, 0]
    for b in range(2):
        keep = worlds[:, 0] == x[b, 0]
        pw = p[keep] / p[keep].sum()
        for v in range(1, 4):
            for s in range(2):
                want = pw[worlds[keep][:, v] == s].sum()
                np.testing.assert_allclose(got[b, v, s], want, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got[b, 0], np.eye(2)[x[b, 0]], atol=1e-12)

    mean = np.asarray(q(x, evidence_mask=mask, store=ctx.parameters))
    np.testing.assert_allclose((got * np.arange(2)).sum(axis=2), mean, rtol=1e-6)


def test_posterior_variance_matches_enumeration():
    """return_variance=True: exact Var[x_v | x_obs] vs the exhaustive
    posterior second moment; observed entries report 0."""
    from cirkit_tpu.backend.jax.queries import ExpectationQuery

    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(95))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)
    x = np.zeros((2, 4), dtype=np.int64)
    x[:, 0] = [0, 1]
    mask = np.zeros((2, 4), dtype=bool)
    mask[:, 0] = True
    mean, var = q(x, evidence_mask=mask, store=ctx.parameters, return_variance=True)
    mean, var = np.asarray(mean), np.asarray(var)

    worlds = enumerate_worlds(4, 2)
    p = eval_circuit(sc, worlds)[:, 0, 0]
    for b in range(2):
        keep = worlds[:, 0] == x[b, 0]
        pw = p[keep] / p[keep].sum()
        m1 = (pw[:, None] * worlds[keep]).sum(axis=0)
        m2 = (pw[:, None] * worlds[keep] ** 2).sum(axis=0)
        want = m2 - m1**2
        np.testing.assert_allclose(var[b, 1:], want[1:], rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(mean[b, 1:], m1[1:], rtol=1e-6, atol=1e-9)
        assert var[b, 0] == 0.0


@pytest.mark.slow
def test_posterior_covariance_matches_enumeration():
    """covariance(): the full (B, k, k) posterior covariance over queried
    variables must match exhaustive posterior second moments; symmetric;
    diagonal equals return_variance; observed rows/cols are zero."""
    from cirkit_tpu.backend.jax.queries import ExpectationQuery

    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(98))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)
    x = np.zeros((2, 4), dtype=np.int64)
    x[:, 0] = [0, 1]
    mask = np.zeros((2, 4), dtype=bool)
    mask[:, 0] = True
    cov = np.asarray(
        q.covariance(x, evidence_mask=mask, variables=(0, 1, 2, 3), store=ctx.parameters)
    )
    assert cov.shape == (2, 4, 4)
    np.testing.assert_allclose(cov, np.transpose(cov, (0, 2, 1)), atol=1e-12)
    _, var = q(x, evidence_mask=mask, store=ctx.parameters, return_variance=True)
    np.testing.assert_allclose(
        np.stack([np.diag(cov[b]) for b in range(2)]), np.asarray(var), rtol=1e-6,
        atol=1e-12,
    )

    worlds = enumerate_worlds(4, 2)
    p = eval_circuit(sc, worlds)[:, 0, 0]
    for b in range(2):
        keep = worlds[:, 0] == x[b, 0]
        pw = p[keep] / p[keep].sum()
        w = worlds[keep].astype(float)
        m = (pw[:, None] * w).sum(axis=0)
        want = (pw[:, None, None] * (w[:, :, None] - m) * (w[:, None, :] - m)).sum(axis=0)
        # observed var 0: constants — zero row/col
        want[0, :] = 0.0
        want[:, 0] = 0.0
        np.testing.assert_allclose(cov[b], want, rtol=1e-5, atol=1e-9)


def test_posterior_covariance_gaussian_closed_form():
    """2-var GMM: Cov(x0, x1 | nothing) = sum_c w_c mu0c mu1c - E0 E1
    (components factorize, so within-component cross-covariance is 0)."""
    from cirkit_tpu.backend.jax.queries import ExpectationQuery
    from cirkit_tpu.symbolic import Circuit, GaussianLayer, HadamardLayer, SumLayer
    from tests.fixtures import const_param

    rng = np.random.default_rng(99)
    k = 3
    mus = rng.normal(scale=2.0, size=(2, k))
    sds = rng.uniform(0.5, 1.2, size=(2, k))
    leaves = [
        GaussianLayer(Scope([v]), k, mean=const_param(mus[v]), stddev=const_param(sds[v]))
        for v in range(2)
    ]
    prod = HadamardLayer(k, arity=2)
    w = rng.dirichlet(np.ones(k))
    root = SumLayer(k, 1, weight=const_param(w[None]))
    sc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)
    x = np.zeros((1, 2))
    mask = np.zeros((1, 2), dtype=bool)
    cov = np.asarray(q.covariance(x, evidence_mask=mask, variables=(0, 1), store=ctx.parameters))
    e = (w[None, :] * mus).sum(axis=1)  # (2,)
    want01 = (w * mus[0] * mus[1]).sum() - e[0] * e[1]
    want00 = (w * (sds[0] ** 2 + mus[0] ** 2)).sum() - e[0] ** 2
    np.testing.assert_allclose(cov[0, 0, 1], want01, rtol=1e-6)
    np.testing.assert_allclose(cov[0, 1, 0], want01, rtol=1e-6)
    np.testing.assert_allclose(cov[0, 0, 0], want00, rtol=1e-6)

    with pytest.raises(ValueError, match="out of range"):
        q.covariance(x, evidence_mask=mask, variables=(0, 5), store=ctx.parameters)


def test_posterior_covariance_through_tucker_layers():
    """The covariance program takes jvp-over-grad through the Tucker
    contractions and their safe log (a custom VJP): the off-diagonals of
    the Hessian-built rows must come out finite and symmetric."""
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.queries import ExpectationQuery
    from cirkit_tpu.models import image_data

    sc = image_data(
        (1, 4, 4), "quad-tree-2", input_layer="categorical",
        num_input_units=8, sum_product_layer="tucker", num_sum_units=8,
    )
    rng = np.random.default_rng(100)
    x = jnp.asarray(rng.integers(0, 256, size=(3, 16)), jnp.int32)
    mask = jnp.asarray(rng.random((3, 16)) < 0.5)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=24)
    cc = ctx.compile(sc)
    free = [v for v in range(16) if not bool(mask[0, v])][:3]
    cov = np.asarray(
        ExpectationQuery(cc).covariance(
            x[:1], evidence_mask=mask[:1], variables=tuple(free), store=ctx.parameters
        )
    )
    assert np.isfinite(cov).all()
    np.testing.assert_allclose(cov[0], cov[0].T, rtol=1e-6, atol=1e-6)
    assert (np.diag(cov[0]) > 0).all()


def test_posterior_variance_gaussian_closed_form():
    """2-var GMM: Var[x_1 | x_0] must equal the closed-form mixture
    variance sum_c r_c (sigma_c^2 + mu_c^2) - (sum_c r_c mu_c)^2."""
    from scipy.stats import norm

    from cirkit_tpu.backend.jax.queries import ExpectationQuery
    from cirkit_tpu.symbolic import Circuit, GaussianLayer, HadamardLayer, SumLayer
    from tests.fixtures import const_param

    rng = np.random.default_rng(96)
    k = 3
    mus = rng.normal(scale=2.0, size=(2, k))
    sds = rng.uniform(0.5, 1.2, size=(2, k))
    leaves = [
        GaussianLayer(Scope([v]), k, mean=const_param(mus[v]), stddev=const_param(sds[v]))
        for v in range(2)
    ]
    prod = HadamardLayer(k, arity=2)
    w = rng.dirichlet(np.ones(k))
    root = SumLayer(k, 1, weight=const_param(w[None]))
    sc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)

    x = np.array([[0.7, 0.0], [-1.5, 0.0]], dtype=np.float64)
    mask = np.array([[True, False]] * 2)
    mean, var = q(x, evidence_mask=mask, store=ctx.parameters, return_variance=True)
    for b in range(2):
        like = np.array([norm.pdf(x[b, 0], mus[0, c], sds[0, c]) for c in range(k)])
        r = w * like / (w * like).sum()
        m1 = (r * mus[1]).sum()
        want = (r * (sds[1] ** 2 + mus[1] ** 2)).sum() - m1**2
        np.testing.assert_allclose(float(var[b, 1]), want, rtol=1e-5)
        assert float(var[b, 0]) == 0.0

    # continuous leaves have no finite support: marginals must refuse
    with pytest.raises(NotImplementedError, match="finite-support"):
        q.marginals(x, evidence_mask=mask, store=ctx.parameters)


def test_posterior_marginals_and_variance_binomial():
    """Binomial leaves: marginals over the 0..n count support and the
    posterior variance vs exhaustive enumeration of all count worlds."""
    from cirkit_tpu.backend.jax.queries import ExpectationQuery
    from cirkit_tpu.symbolic import BinomialLayer, Circuit, HadamardLayer, SumLayer
    from tests.fixtures import const_param

    rng = np.random.default_rng(97)
    k, n = 3, 4
    probs = rng.uniform(0.2, 0.8, size=(2, k))
    leaves = [
        BinomialLayer(Scope([v]), k, total_count=n, probs=const_param(probs[v]))
        for v in range(2)
    ]
    prod = HadamardLayer(k, arity=2)
    w = rng.dirichlet(np.ones(k))
    root = SumLayer(k, 1, weight=const_param(w[None]))
    sc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    q = ExpectationQuery(cc)

    x = np.array([[2, 0], [4, 0]], dtype=np.int64)
    mask = np.array([[True, False]] * 2)
    marg = np.asarray(q.marginals(x, evidence_mask=mask, store=ctx.parameters))
    mean, var = q(x, evidence_mask=mask, store=ctx.parameters, return_variance=True)
    assert marg.shape == (2, 2, n + 1)

    worlds = enumerate_worlds(2, n + 1)
    p = eval_circuit(sc, worlds)[:, 0, 0]
    for b in range(2):
        keep = worlds[:, 0] == x[b, 0]
        pw = p[keep] / p[keep].sum()
        for s in range(n + 1):
            want = pw[worlds[keep][:, 1] == s].sum()
            np.testing.assert_allclose(marg[b, 1, s], want, rtol=1e-5, atol=1e-9)
        m1 = (pw * worlds[keep][:, 1]).sum()
        m2 = (pw * worlds[keep][:, 1] ** 2).sum()
        np.testing.assert_allclose(float(mean[b, 1]), m1, rtol=1e-5)
        np.testing.assert_allclose(float(var[b, 1]), m2 - m1**2, rtol=1e-5)


@pytest.mark.slow
def test_marginals_bf16_output_matches_f32():
    """marginals(dtype=bf16): same distributions at bf16 rounding, rows
    still ~normalized, observed one-hots exact."""
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.queries import ExpectationQuery
    from cirkit_tpu.models import image_data

    sc = image_data(
        (1, 2, 2), "quad-tree-2", input_layer="categorical",
        num_input_units=4, sum_product_layer="cp", num_sum_units=4,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, seed=3)
    cc = ctx.compile(sc)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.integers(0, 256, size=(5, 4)), jnp.int32)
    mask = jnp.asarray(rng.random((5, 4)) < 0.5)
    q = ExpectationQuery(cc)
    f32 = np.asarray(q.marginals(x, evidence_mask=mask, store=ctx.parameters))
    b16 = q.marginals(x, evidence_mask=mask, store=ctx.parameters, dtype=jnp.bfloat16)
    assert b16.dtype == jnp.bfloat16
    b16 = np.asarray(b16).astype(np.float32)
    np.testing.assert_allclose(b16, f32, atol=4e-3)
    np.testing.assert_allclose(b16.sum(-1), 1.0, atol=2e-2)
    obs = np.asarray(mask)
    xi = np.asarray(x)
    assert (b16[obs][np.arange(obs.sum()), xi[obs]] == 1.0).all()


@pytest.mark.slow
def test_pad_batch_to_on_queries():
    """pad_batch_to: ragged batches reuse one compiled program per query
    and results match the unpadded calls exactly (MAP/top-k/conditional/
    integrate/expectation/marginals/cdf/quantile)."""
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.queries import (
        ExpectationQuery,
        IntegrateQuery,
        MAPQuery,
        SamplingQuery,
    )
    from cirkit_tpu.models import image_data

    sc = image_data(
        (1, 2, 2), "quad-tree-2", input_layer="categorical",
        num_input_units=4, sum_product_layer="tucker", num_sum_units=4,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, seed=8)
    cc = ctx.compile(sc)
    st = ctx.parameters
    rng = np.random.default_rng(11)
    for b in (3, 5, 8):
        x = jnp.asarray(rng.integers(0, 256, size=(b, 4)), jnp.int32)
        mask = jnp.asarray(rng.random((b, 4)) < 0.5)

        a1, v1 = MAPQuery(cc)(x, evidence_mask=mask, store=st)
        a2, v2 = MAPQuery(cc)(x, evidence_mask=mask, store=st, pad_batch_to=8)
        assert a2.shape == (b, 4)
        np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2))

        t1, s1 = MAPQuery(cc)(x, evidence_mask=mask, store=st, top_k=2)
        t2, s2 = MAPQuery(cc)(x, evidence_mask=mask, store=st, top_k=2,
                              pad_batch_to=8)
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2))

        key = jax.random.PRNGKey(0)
        c1, l1 = SamplingQuery(cc).conditional(x, evidence_mask=mask, key=key, store=st)
        c2, l2 = SamplingQuery(cc).conditional(
            x, evidence_mask=mask, key=key, store=st, pad_batch_to=8
        )
        assert c2.shape == (b, 4)
        np.testing.assert_allclose(np.asarray(l1), np.asarray(l2))

        i1 = IntegrateQuery(cc)(x, integrate_vars=mask, store=st)
        i2 = IntegrateQuery(cc)(x, integrate_vars=mask, store=st, pad_batch_to=8)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

        q = ExpectationQuery(cc)
        e1, var1 = q(x, evidence_mask=mask, store=st, return_variance=True)
        e2, var2 = q(x, evidence_mask=mask, store=st, return_variance=True,
                     pad_batch_to=8)
        # responsibility reductions reorder with the padded batch shape:
        # ulp-level drift, not a padding artifact
        np.testing.assert_allclose(np.asarray(e1), np.asarray(e2), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(var1), np.asarray(var2),
                                   rtol=1e-9, atol=1e-12)
        m1 = q.marginals(x, evidence_mask=mask, store=st)
        m2 = q.marginals(x, evidence_mask=mask, store=st, pad_batch_to=8)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2),
                                   rtol=1e-12, atol=1e-15)
        f1 = q.cdf(x, t=100.0, evidence_mask=mask, store=st)
        f2 = q.cdf(x, t=100.0, evidence_mask=mask, store=st, pad_batch_to=8)
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f2),
                                   rtol=1e-12, atol=1e-15)
        u1 = q.quantile(x, q=0.7, evidence_mask=mask, store=st)
        u2 = q.quantile(x, q=0.7, evidence_mask=mask, store=st, pad_batch_to=8)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u2),
                                   rtol=1e-9, atol=1e-9)
