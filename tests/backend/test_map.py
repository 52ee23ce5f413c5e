"""MAPQuery tests: max-product MPE against exhaustive enumeration with a
numpy max-eval oracle, conditional completion, full-evidence consistency,
optimized (Tucker/CPT) circuits, Gaussian modes, and error cases. The query
is an extension — the reference has no MAP/MPE query."""

import jax.numpy as jnp
import numpy as np
import pytest

from cirkit_tpu.backend.jax.queries import MAPQuery
from cirkit_tpu.pipeline import PipelineContext

from tests.fixtures import (
    build_bivariate_categorical_pc,
    build_bivariate_gaussian_pc,
    build_multivariate_categorical_pc,
)
from tests.reference_eval import max_eval_circuit, mpe_by_enumeration


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("product", ["hadamard", "kronecker"])
def test_map_unconditional_matches_enumeration(fold, product):
    sc = build_bivariate_categorical_pc(product=product, rng=np.random.default_rng(30))
    ctx = PipelineContext(semiring="lse-sum", fold=fold)
    cc = ctx.compile(sc)
    asg, val = MAPQuery(cc)(store=ctx.parameters)
    want_asg, want_val = mpe_by_enumeration(sc, 3)
    np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), want_asg)
    np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)


def test_map_deep_circuit_matches_enumeration():
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(31))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    asg, val = MAPQuery(cc)(store=ctx.parameters)
    want_asg, want_val = mpe_by_enumeration(sc, 2)
    np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), want_asg)
    np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)


def test_map_conditional_completion_matches_restricted_enumeration():
    """Pin variable 0 to each category; the query must return the best
    completion over the free variables, per sample, in one batched call."""
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(32))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    query = MAPQuery(cc)
    x = np.zeros((2, 4), dtype=np.int64)
    x[:, 0] = [0, 1]
    mask = np.zeros((2, 4), dtype=bool)
    mask[:, 0] = True
    asg, val = query(x, evidence_mask=mask, store=ctx.parameters)
    for b in range(2):
        observed = np.array([x[b, 0], -1, -1, -1])
        want_asg, want_val = mpe_by_enumeration(sc, 2, observed=observed)
        np.testing.assert_array_equal(np.asarray(asg[b]).astype(int), want_asg)
        np.testing.assert_allclose(float(val[b]), np.log(want_val), rtol=1e-9)


def test_map_per_head_selection_matches_enumeration():
    """output/unit select the root head: per head h, the MAP assignment
    and value must match exhaustive max-product enumeration of THAT
    head's distribution (e.g. class-conditional MPE)."""
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from cirkit_tpu.utils import Scope

    from tests.fixtures import const_param
    from tests.reference_eval import enumerate_worlds, max_eval_circuit

    rng = np.random.default_rng(60)
    k, heads = 3, 3
    leaves = [
        CategoricalLayer(
            Scope([v]), k, num_categories=3,
            probs=const_param(rng.dirichlet(np.ones(3), size=k)),
        )
        for v in range(3)
    ]
    prod = HadamardLayer(k, arity=3)
    root = SumLayer(k, heads, weight=const_param(rng.dirichlet(np.ones(k), size=heads)))
    sc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    query = MAPQuery(cc)

    worlds = enumerate_worlds(3, 3)
    head_vals = max_eval_circuit(sc, worlds)[:, 0, :]  # (W, heads)
    got_heads = []
    for h in range(heads):
        asg, val = query(store=ctx.parameters, unit=h)
        best = int(np.argmax(head_vals[:, h]))
        np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), worlds[best])
        np.testing.assert_allclose(float(val[0]), np.log(head_vals[best, h]), rtol=1e-9)
        got_heads.append(tuple(np.asarray(asg[0]).astype(int)))
    with pytest.raises(ValueError, match="root unit"):
        query(store=ctx.parameters, unit=heads)
    with pytest.raises(ValueError, match="root output"):
        query(store=ctx.parameters, output=1)


@pytest.mark.slow
def test_conditional_sampling_per_head_log_evidence():
    """conditional(..., unit=h) conditions on head h: its log-evidence must
    equal that head's marginal over the free variables."""
    import jax

    from cirkit_tpu.backend.jax.queries import IntegrateQuery, SamplingQuery
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from cirkit_tpu.utils import Scope

    from tests.fixtures import const_param

    rng = np.random.default_rng(61)
    k, heads = 2, 3
    leaves = [
        CategoricalLayer(
            Scope([v]), k, num_categories=3,
            probs=const_param(rng.dirichlet(np.ones(3), size=k)),
        )
        for v in range(3)
    ]
    prod = HadamardLayer(k, arity=3)
    root = SumLayer(k, heads, weight=const_param(rng.dirichlet(np.ones(k), size=heads)))
    sc = Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    sq = SamplingQuery(cc)
    iq = IntegrateQuery(cc)

    x = jnp.asarray(rng.integers(0, 3, size=(8, 3)))
    mask = np.zeros((8, 3), dtype=bool)
    mask[:, 0] = True
    for h in range(heads):
        s, le = sq.conditional(
            x, evidence_mask=jnp.asarray(mask), key=jax.random.PRNGKey(h),
            store=ctx.parameters, unit=h,
        )
        marg = iq(x, integrate_vars=jnp.asarray(~mask), store=ctx.parameters)[:, 0, h]
        np.testing.assert_allclose(np.asarray(le), np.asarray(marg), rtol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(s)[:, 0], np.asarray(x)[:, 0]
        )


def test_map_full_evidence_returns_input_and_best_parse_value():
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(33))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    from tests.reference_eval import enumerate_worlds

    worlds = enumerate_worlds(4, 2)
    mask = np.ones((len(worlds), 4), dtype=bool)
    asg, val = MAPQuery(cc)(worlds, evidence_mask=mask, store=ctx.parameters)
    np.testing.assert_array_equal(np.asarray(asg).astype(int), worlds)
    want = np.log(max_eval_circuit(sc, worlds)[:, 0, 0])
    np.testing.assert_allclose(np.asarray(val), want, rtol=1e-9)


def test_map_all_false_mask_equals_unconditional():
    sc = build_bivariate_categorical_pc(rng=np.random.default_rng(34))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    query = MAPQuery(cc)
    asg_u, val_u = query(store=ctx.parameters)
    x = np.array([[2, 2], [0, 1]], dtype=np.int64)
    asg_c, val_c = query(x, evidence_mask=np.zeros((2, 2), dtype=bool), store=ctx.parameters)
    for b in range(2):
        np.testing.assert_array_equal(np.asarray(asg_c[b]), np.asarray(asg_u[0]))
        np.testing.assert_allclose(float(val_c[b]), float(val_u[0]), rtol=1e-12)


def test_map_gaussian_mode_routing():
    """Continuous MPE: the returned assignment is the mean pair of the
    best-scoring mixture component."""
    sc = build_bivariate_gaussian_pc(num_units=3, rng=np.random.default_rng(35))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    asg, val = MAPQuery(cc)(store=ctx.parameters)

    from tests.reference_eval import eval_parameter

    layers = [l for l in sc.topological_ordering()][:2]
    means = np.stack([eval_parameter(l.mean) for l in layers])  # (2, K)
    stds = np.stack([eval_parameter(l.stddev) for l in layers])
    sum_layer = sc.outputs[0]
    w = eval_parameter(sum_layer.weight)[0]  # (K,)
    # best parse: argmax_k w_k * N_1k(mean_1k) * N_2k(mean_2k)
    peak = 1.0 / (stds * np.sqrt(2 * np.pi))
    scores = w * peak.prod(axis=0)
    k_star = int(np.argmax(scores))
    np.testing.assert_allclose(np.asarray(asg[0]), means[:, k_star], rtol=1e-9)
    np.testing.assert_allclose(float(val[0]), np.log(scores[k_star]), rtol=1e-9)


@pytest.mark.slow
def test_map_on_optimized_image_circuit():
    """Template circuit compiled folded+optimized (Tucker fusions): MAP runs
    through the fused layers; full-evidence values must lower-bound the true
    log-likelihood, and observed entries must round-trip."""
    from cirkit_tpu.models import image_data

    sc = image_data(
        (1, 4, 4), "quad-graph", input_layer="categorical",
        num_input_units=3, sum_product_layer="tucker", num_sum_units=3,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=5)
    cc = ctx.compile(sc)
    query = MAPQuery(cc)
    rng = np.random.default_rng(36)
    x = rng.integers(0, 256, size=(3, 16))
    mask = rng.random((3, 16)) < 0.5
    asg, val = query(x, evidence_mask=mask, store=ctx.parameters)
    asg = np.asarray(asg)
    np.testing.assert_array_equal(asg[mask].astype(int), x[mask])
    # best-parse weight lower-bounds the completed assignment's likelihood
    ll = np.asarray(cc.evaluate(ctx.parameters, jnp.asarray(asg.astype(np.int64))))[:, 0, 0]
    assert (np.asarray(val) <= ll + 1e-6).all()
    assert np.isfinite(np.asarray(val)).all()


def test_map_mixing_sum_arity2_matches_enumeration():
    """A sum over two product children (the mixing-layer shape, arity 2):
    the max routes across the concatenated child units."""
    from cirkit_tpu.symbolic import CategoricalLayer, Circuit, HadamardLayer, SumLayer
    from cirkit_tpu.utils import Scope

    from tests.fixtures import const_param

    rng = np.random.default_rng(38)
    k = 2

    def leaf(v):
        raw = rng.uniform(0.1, 1.0, size=(k, 3))
        return CategoricalLayer(
            Scope([v]), k, num_categories=3,
            probs=const_param(raw / raw.sum(axis=1, keepdims=True)),
        )

    leaves = [leaf(0), leaf(1), leaf(0), leaf(1)]
    prod1, prod2 = HadamardLayer(k, arity=2), HadamardLayer(k, arity=2)
    root = SumLayer(k, 1, arity=2, weight=const_param(rng.uniform(0.1, 1.0, (1, 2 * k))))
    sc = Circuit(
        leaves + [prod1, prod2, root],
        {prod1: leaves[:2], prod2: leaves[2:], root: [prod1, prod2]},
        [root],
    )
    for fold in (False, True):
        ctx = PipelineContext(semiring="lse-sum", fold=fold)
        cc = ctx.compile(sc)
        asg, val = MAPQuery(cc)(store=ctx.parameters)
        want_asg, want_val = mpe_by_enumeration(sc, 3)
        np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), want_asg)
        np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)


def test_map_errors():
    sc = build_bivariate_categorical_pc(rng=np.random.default_rng(37))
    ctx = PipelineContext(semiring="sum-product", fold=True)
    cc = ctx.compile(sc)
    with pytest.raises(ValueError, match="lse-sum"):
        MAPQuery(cc)

    ctx2 = PipelineContext(semiring="lse-sum", fold=True)
    cc2 = ctx2.compile(sc)
    query = MAPQuery(cc2)
    with pytest.raises(ValueError, match="evidence_mask"):
        query(np.zeros((1, 2), dtype=np.int64), store=ctx2.parameters)
    with pytest.raises(ValueError, match="boolean"):
        query(
            np.zeros((1, 2), dtype=np.int64),
            evidence_mask=np.zeros((1, 2), dtype=np.int64),
            store=ctx2.parameters,
        )
    with pytest.raises(ValueError, match="requires an input batch"):
        query(evidence_mask=np.zeros((1, 2), dtype=bool), store=ctx2.parameters)


@pytest.mark.parametrize("fold", [False, True])
def test_map_through_tensordot_shattered_sums(fold):
    """Product circuits compile (optimize=True) to Kronecker-shattered
    tensor-dot pairs; MAP must route through both Monarch halves and still
    match exhaustive enumeration of the symbolic product."""
    import cirkit_tpu.symbolic.functional as SF
    from cirkit_tpu.backend.jax.optimized import JaxTensorDotLayer

    sc1 = build_multivariate_categorical_pc(rng=np.random.default_rng(61))
    sc2 = build_multivariate_categorical_pc(rng=np.random.default_rng(62))
    psc = SF.multiply(sc1, sc2)
    ctx = PipelineContext(semiring="lse-sum", fold=fold, optimize=True)
    cc = ctx.compile(psc)
    assert any(isinstance(l, JaxTensorDotLayer) for l in cc.layers)

    asg, val = MAPQuery(cc)(store=ctx.parameters)
    want_asg, want_val = mpe_by_enumeration(psc, 2)
    np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), want_asg)
    np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)


def test_conditional_sampling_through_tensordot():
    """Full-evidence conditional draws through tensor-dot pairs return the
    input and the product circuit's log-likelihood."""
    import jax

    import cirkit_tpu.symbolic.functional as SF
    from cirkit_tpu.backend.jax.queries import SamplingQuery
    from tests.reference_eval import enumerate_worlds, eval_circuit

    sc1 = build_multivariate_categorical_pc(rng=np.random.default_rng(63))
    sc2 = build_multivariate_categorical_pc(rng=np.random.default_rng(64))
    psc = SF.multiply(sc1, sc2)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(psc)
    worlds = enumerate_worlds(4, 2)
    samples, vals = SamplingQuery(cc).conditional(
        worlds, evidence_mask=np.ones((len(worlds), 4), dtype=bool),
        key=jax.random.PRNGKey(4), store=ctx.parameters,
    )
    np.testing.assert_array_equal(np.asarray(samples).astype(int), worlds)
    want = np.log(eval_circuit(sc1, worlds)[:, 0, 0] * eval_circuit(sc2, worlds)[:, 0, 0])
    np.testing.assert_allclose(np.asarray(vals), want, rtol=1e-8)


@pytest.mark.slow
def test_map_and_conditional_accept_scope_evidence():
    """Scope-based evidence specs work like IntegrateQuery's (observed =
    the given scope), matching the boolean-mask result exactly."""
    import jax

    from cirkit_tpu.backend.jax.queries import SamplingQuery
    from cirkit_tpu.utils import Scope

    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(65))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    x = np.array([[1, 0, 1, 0], [0, 1, 0, 1]], dtype=np.int64)
    mask = np.zeros((2, 4), dtype=bool)
    mask[:, [0, 2]] = True

    q = MAPQuery(cc)
    a1, v1 = q(x, evidence_mask=mask, store=ctx.parameters)
    a2, v2 = q(x, evidence_mask=Scope([0, 2]), store=ctx.parameters)
    a3, v3 = q(x, evidence_mask=[Scope([0, 2]), Scope([0, 2])], store=ctx.parameters)
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a3))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-12)

    s1, _ = SamplingQuery(cc).conditional(
        x, evidence_mask=mask, key=jax.random.PRNGKey(5), store=ctx.parameters
    )
    s2, _ = SamplingQuery(cc).conditional(
        x, evidence_mask=Scope([0, 2]), key=jax.random.PRNGKey(5), store=ctx.parameters
    )
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))


def test_marginal_map_matches_enumeration():
    """marginalize_vars: argmax over the free variables of the circuit's
    max-product value with the marginalized leaves summed out — must match
    exhaustive enumeration with the marginal-MAP oracle, per sample."""
    sc = build_multivariate_categorical_pc(num_variables=4, rng=np.random.default_rng(62))
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    query = MAPQuery(cc)
    from cirkit_tpu.utils import Scope

    from tests.reference_eval import enumerate_worlds

    # observe var 0, marginalize var 2, maximize vars {1, 3}
    x = np.zeros((2, 4), dtype=np.int64)
    x[:, 0] = [0, 1]
    obs = np.zeros((2, 4), dtype=bool)
    obs[:, 0] = True
    asg, val = query(
        x, evidence_mask=obs, marginalize_vars=Scope([2]), store=ctx.parameters
    )
    worlds = enumerate_worlds(4, 2)
    mvals = max_eval_circuit(sc, worlds, marginalized={2}, num_states=2)[:, 0, 0]
    for b in range(2):
        keep = (worlds[:, 0] == x[b, 0]) & (worlds[:, 2] == 0)  # var2 dummy-pinned
        cand = np.where(keep)[0]
        best = cand[np.argmax(mvals[cand])]
        want = worlds[best].astype(float)
        want[2] = 0.0  # marginalized entries return 0
        np.testing.assert_array_equal(np.asarray(asg[b]), want)
        np.testing.assert_allclose(float(val[b]), np.log(mvals[best]), rtol=1e-9)

    # all-marginalized free set degenerates to IntegrateQuery... of the
    # max-product circuit; sanity: no overlap allowed
    with pytest.raises(ValueError, match="both observed"):
        query(x, evidence_mask=obs, marginalize_vars=Scope([0]), store=ctx.parameters)


def test_map_and_topk_through_collapsed_sums():
    """Sum-collapse regression: a dense root over a mixing sum fuses into
    ONE sum whose weight is ``MatMul(W_mix, W_root)`` — a SUM over the fused
    latent. The (+,*) forward and sampling are invariant to that, but MPE
    maxes over every latent: the tropical carrier must use the max-product
    of the factors (queries._max_weight), and parse-level top-k must KEEP
    the latent as extra candidates (topk._parse_weight). Before the fix the
    optimized MAP value exceeded the true maximum by the latent mass."""
    from cirkit_tpu.backend.jax.parameters import JaxMatMulParameter
    from cirkit_tpu.symbolic import Circuit, HadamardLayer, SumLayer
    from cirkit_tpu.symbolic.layers import CategoricalLayer
    from cirkit_tpu.utils import Scope

    from tests.fixtures import const_param
    from tests.reference_eval import topk_parses_by_enumeration

    rng = np.random.default_rng(7)
    leaves, hads = [], []
    in_layers = {}
    for _ in range(2):
        pair = []
        for v in range(2):
            raw = rng.uniform(0.1, 1.0, size=(2, 3))
            pair.append(
                CategoricalLayer(
                    Scope([v]), 2, num_categories=3,
                    probs=const_param(raw / raw.sum(axis=1, keepdims=True)),
                )
            )
        h = HadamardLayer(2, arity=2)
        in_layers[h] = pair
        leaves.extend(pair)
        hads.append(h)
    mix = SumLayer(2, 2, arity=2, weight=const_param(rng.uniform(0.1, 1.0, (2, 4))))
    root = SumLayer(2, 1, weight=const_param(rng.uniform(0.1, 1.0, (1, 2))))
    in_layers[mix] = hads
    in_layers[root] = [mix]
    sc = Circuit(leaves + hads + [mix, root], in_layers, [root])

    want_asg, want_val = mpe_by_enumeration(sc, 3)
    want_scores, _ = topk_parses_by_enumeration(sc, 3, 4)

    for optimize in (False, True):
        ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize)
        cc = ctx.compile(sc)
        if optimize:
            # the collapse must actually fire, or this test is vacuous
            assert any(
                isinstance(n, JaxMatMulParameter)
                for e in cc._entries
                if hasattr(e.layer, "weight")
                for n in e.layer.weight._ordering
            )
        asg, val = MAPQuery(cc)(store=ctx.parameters)
        np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)
        np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), want_asg)
        _, scores = MAPQuery(cc)(store=ctx.parameters, top_k=4)
        np.testing.assert_allclose(np.asarray(scores[0]), want_scores, rtol=1e-9)


def test_map_and_topk_through_collapsed_tucker():
    """Sum -> Sum -> Kronecker: optimize=True first collapses the dense
    chain (MatMul weight) and then Tucker-fuses it, so the TUCKER layer
    carries the collapsed weight graph. MAP (tropical max over the fused
    latent) and parse top-k (latent kept as extra candidates) must match
    the unoptimized compile and the enumeration oracles."""
    from cirkit_tpu.backend.jax.optimized import JaxTuckerLayer
    from cirkit_tpu.backend.jax.parameters import JaxMatMulParameter
    from cirkit_tpu.symbolic import Circuit, KroneckerLayer, SumLayer
    from cirkit_tpu.symbolic.layers import CategoricalLayer
    from cirkit_tpu.utils import Scope

    from tests.fixtures import const_param
    from tests.reference_eval import topk_parses_by_enumeration

    rng = np.random.default_rng(3)

    def leaf(v):
        raw = rng.uniform(0.1, 1.0, size=(2, 3))
        return CategoricalLayer(
            Scope([v]), 2, num_categories=3,
            probs=const_param(raw / raw.sum(axis=1, keepdims=True)),
        )

    l0, l1 = leaf(0), leaf(1)
    kr = KroneckerLayer(2, arity=2)
    s1 = SumLayer(4, 3, weight=const_param(rng.uniform(0.1, 1.0, (3, 4))))
    s2 = SumLayer(3, 1, weight=const_param(rng.uniform(0.1, 1.0, (1, 3))))
    sc = Circuit([l0, l1, kr, s1, s2], {kr: [l0, l1], s1: [kr], s2: [s1]}, [s2])

    want_asg, want_val = mpe_by_enumeration(sc, 3)
    want_scores, _ = topk_parses_by_enumeration(sc, 3, 5)
    for optimize in (False, True):
        ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize)
        cc = ctx.compile(sc)
        if optimize:
            assert any(
                isinstance(e.layer, JaxTuckerLayer)
                and any(
                    isinstance(n, JaxMatMulParameter)
                    for n in e.layer.weight._ordering
                )
                for e in cc._entries
            )
        asg, val = MAPQuery(cc)(store=ctx.parameters)
        np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)
        np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), want_asg)
        _, scores = MAPQuery(cc)(store=ctx.parameters, top_k=5)
        np.testing.assert_allclose(np.asarray(scores[0]), want_scores, rtol=1e-9)


def test_max_and_parse_weight_guard_non_matmul_consumers():
    """A MatMul feeding any non-MatMul plan node (e.g. a user optimization
    rule emitting Softmax(MatMul(...))) must raise loudly in BOTH routing
    weight evaluators — the (+,*) forward would normalize the SUMMED
    composite while the tropical/parse paths see different values, so a
    silent answer would be a silently wrong MPE. Plain MatMul plans keep
    evaluating (tropical product / expanded columns pinned vs numpy)."""
    from cirkit_tpu.backend.jax.parameters import (
        JaxMatMulParameter,
        JaxParameter,
        JaxSoftmaxParameter,
        JaxTensorSlot,
    )
    from cirkit_tpu.backend.jax.queries import _max_weight
    from cirkit_tpu.backend.jax.topk import _parse_weight

    rng = np.random.default_rng(7)
    j, i, o = 3, 4, 2
    w1v = rng.uniform(0.1, 1.0, size=(1, j, i))
    w2v = rng.uniform(0.1, 1.0, size=(1, o, j))
    store = {"w1": jnp.asarray(w1v), "w2": jnp.asarray(w2v)}

    def slot(name, shape):
        return JaxTensorSlot(
            name, shape, dtype=jnp.float32, learnable=True,
            inits=[None], origins=[None],
        )

    s1, s2 = slot("w1", (j, i)), slot("w2", (o, j))
    mm = JaxMatMulParameter((j, i), (o, j))
    plain = JaxParameter([s1, s2, mm], {mm: [s1, s2]}, [mm])

    got_max = np.asarray(_max_weight(plain, store))
    want_max = (w2v[0][:, :, None] * w1v[0][None, :, :]).max(axis=1)
    np.testing.assert_allclose(got_max[0], want_max, rtol=1e-6)

    got_parse = np.asarray(_parse_weight(plain, store))
    want_parse = (w2v[0][:, :, None] * w1v[0][None, :, :]).reshape(o, j * i)
    np.testing.assert_allclose(got_parse[0], want_parse, rtol=1e-6)

    sm = JaxSoftmaxParameter((o, i), axis=-1)
    guarded = JaxParameter(
        [s1, s2, mm, sm], {mm: [s1, s2], sm: [mm]}, [sm]
    )
    with pytest.raises(NotImplementedError, match="MatMul feeds"):
        _max_weight(guarded, store)
    with pytest.raises(NotImplementedError, match="MatMul feeds"):
        _parse_weight(guarded, store)


def _tucker_pc(rng, num_units=3, num_categories=3):
    """Four categorical variables, Kronecker products under dense sums:
    optimize=True fuses every Kronecker+Sum pair into a Tucker layer."""
    from cirkit_tpu.symbolic import Circuit, KroneckerLayer, SumLayer
    from cirkit_tpu.symbolic.layers import CategoricalLayer
    from cirkit_tpu.utils import Scope

    from tests.fixtures import const_param

    def leaf(v):
        raw = rng.uniform(0.1, 1.0, size=(num_units, num_categories))
        return CategoricalLayer(
            Scope([v]), num_units, num_categories=num_categories,
            probs=const_param(raw / raw.sum(axis=1, keepdims=True)),
        )

    def normalized(shape):
        raw = rng.uniform(0.1, 1.0, shape)
        return const_param(raw / raw.sum(axis=1, keepdims=True))

    leaves = [leaf(v) for v in range(4)]
    k01, k23 = KroneckerLayer(num_units, arity=2), KroneckerLayer(num_units, arity=2)
    s01 = SumLayer(num_units**2, num_units, weight=normalized((num_units, num_units**2)))
    s23 = SumLayer(num_units**2, num_units, weight=normalized((num_units, num_units**2)))
    root_k = KroneckerLayer(num_units, arity=2)
    root = SumLayer(num_units**2, 1, weight=normalized((1, num_units**2)))
    layers = leaves + [k01, k23, s01, s23, root_k, root]
    ins = {
        k01: leaves[:2], k23: leaves[2:], s01: [k01], s23: [k23],
        root_k: [s01, s23], root: [root_k],
    }
    return Circuit(layers, ins, [root])


def _compile_tucker(sc):
    from cirkit_tpu.backend.jax.optimized import JaxTuckerLayer

    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    assert any(isinstance(e.layer, JaxTuckerLayer) for e in cc._entries)
    return ctx, cc


@pytest.mark.parametrize(
    "observed", [[-1, -1, -1, -1], [2, -1, -1, -1], [-1, 0, -1, 1]],
    ids=["none", "var0", "vars1-3"],
)
def test_map_tucker_matches_enumeration(observed):
    """MAP with evidence through fused Tucker layers: the exhaustive
    max-product oracle's completion and value."""
    sc = _tucker_pc(np.random.default_rng(64))
    ctx, cc = _compile_tucker(sc)
    observed = np.asarray(observed)
    x = np.where(observed < 0, 0, observed)[None].astype(np.int64)
    asg, val = MAPQuery(cc)(x, evidence_mask=(observed >= 0)[None], store=ctx.parameters)
    want_asg, want_val = mpe_by_enumeration(sc, 3, observed=observed)
    np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), want_asg)
    np.testing.assert_allclose(float(val[0]), np.log(want_val), rtol=1e-9)


@pytest.mark.parametrize(
    "observed", [[-1, -1, -1, -1], [1, -1, -1, 2]], ids=["none", "vars0-3"]
)
def test_conditional_sampling_tucker_matches_enumeration(observed):
    """Conditional draws through fused Tucker layers follow the enumerated
    posterior p(x_free | x_obs); the log-evidence is exact."""
    import jax

    from cirkit_tpu.backend.jax.queries import SamplingQuery

    from tests.reference_eval import enumerate_worlds, eval_circuit

    sc = _tucker_pc(np.random.default_rng(65))
    ctx, cc = _compile_tucker(sc)
    observed = np.asarray(observed)
    obs = observed >= 0
    n = 20000
    x = np.tile(np.where(obs, observed, 0), (n, 1)).astype(np.int64)
    samples, le = SamplingQuery(cc).conditional(
        x, evidence_mask=np.tile(obs, (n, 1)), key=jax.random.PRNGKey(3),
        store=ctx.parameters,
    )
    samples = np.asarray(samples).astype(int)
    np.testing.assert_array_equal(samples[:, obs], x[:, obs])

    worlds = enumerate_worlds(4, 3)
    keep = ((worlds == observed[None]) | ~obs[None]).all(axis=1)
    p = eval_circuit(sc, worlds[keep])[:, 0, 0]
    np.testing.assert_allclose(np.asarray(le), np.log(p.sum()), rtol=1e-9, atol=1e-12)
    index = {tuple(w): i for i, w in enumerate(worlds[keep])}
    counts = np.bincount([index[tuple(s)] for s in samples], minlength=len(p))
    tv = 0.5 * np.abs(counts / n - p / p.sum()).sum()
    assert tv < 0.04, tv
