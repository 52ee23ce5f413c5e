"""Randomized structural fuzzing: random region graphs x sum-product blocks
x compilation options, every compiled output checked against exhaustive
enumeration and the integral circuit against the brute-force partition
function. This net goes beyond the reference's fixed fixtures — any
folding/optimization/fusion bug on an unusual topology shows up here."""

import itertools

import numpy as np
import pytest

from cirkit_tpu.models.region_graph import QuadGraph, QuadTree, RandomBinaryTree
from cirkit_tpu.pipeline import PipelineContext
from cirkit_tpu.symbolic.initializers import ConstantTensorInitializer
from cirkit_tpu.symbolic.layers import CategoricalLayer
from cirkit_tpu.symbolic.parameters import Parameter, SoftmaxParameter, TensorParameter

from tests.reference_eval import eval_circuit

pytestmark = pytest.mark.slow  # fuzz grids enumerate ground truth per case

NUM_CATS = 3


def _random_circuit(seed: int):
    rng = np.random.default_rng(seed)

    # constant numpy draws + symbolic softmax graphs, so the enumeration
    # oracle can evaluate the exact same parameters
    def softmax_const(shape):
        t = TensorParameter(
            *shape, initializer=ConstantTensorInitializer(rng.normal(size=shape))
        )
        return Parameter.from_unary(SoftmaxParameter(shape), t)

    def input_factory(scope, num_units):
        return CategoricalLayer(
            scope, num_units, num_categories=NUM_CATS,
            probs=softmax_const((num_units, NUM_CATS)),
        )

    kind = seed % 3
    if kind == 0:
        rg = RandomBinaryTree(int(rng.integers(4, 8)), seed=seed)
    elif kind == 1:
        rg = QuadTree((1, 2, 3), num_patch_splits=2)
    else:
        rg = QuadGraph((1, 3, 2))
    sum_product = ["cp", "cp-t", "tucker"][seed % 3]
    return rg.build_circuit(
        input_factory=input_factory,
        sum_product=sum_product,
        sum_weight_factory=softmax_const,
        num_input_units=int(rng.integers(1, 4)),
        num_sum_units=int(rng.integers(1, 4)),
    )


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("fold,optimize", [(False, False), (True, False), (True, True)])
def test_random_circuit_matches_enumeration(seed, fold, optimize):
    sc = _random_circuit(seed)
    assert sc.is_smooth and sc.is_decomposable
    d = sc.num_variables
    worlds = np.array(list(itertools.product(range(NUM_CATS), repeat=d)), dtype=np.int64)
    want = eval_circuit(sc, worlds)[:, 0, 0]

    ctx = PipelineContext(semiring="lse-sum", fold=fold, optimize=optimize)
    cc = ctx.compile(sc)
    got = np.exp(np.asarray(cc(worlds))[:, 0, 0])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)

    icc = ctx.integrate(cc)
    z = np.exp(np.asarray(icc(ctx.parameters, worlds[:1]))[0, 0, 0])
    np.testing.assert_allclose(z, want.sum(), rtol=1e-9)
    # softmax-normalized circuits are proper distributions
    np.testing.assert_allclose(z, 1.0, rtol=1e-9)

    # MAP: the max-product assignment and value match the exhaustive
    # max-eval oracle on every random topology x compile option
    from cirkit_tpu.backend.jax.queries import MAPQuery

    from tests.reference_eval import max_eval_circuit

    asg, val = MAPQuery(cc)(store=ctx.parameters)
    mx = max_eval_circuit(sc, worlds)[:, 0, 0]
    best = int(np.argmax(mx))
    np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), worlds[best])
    np.testing.assert_allclose(float(val[0]), np.log(mx[best]), rtol=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_random_circuit_prune_roundtrip(seed):
    """Pruning fuzz over the same random topologies (incl. shared-region
    QuadGraph DAGs and all three sum-product blocks): threshold=0 is a
    lossless rebuild, and a light threshold yields a sub-sum of the
    mixture — never more mass, never NaN."""
    from cirkit_tpu.backend.jax.pruning import prune_circuit

    sc = _random_circuit(seed)
    d = sc.num_variables
    worlds = np.array(list(itertools.product(range(NUM_CATS), repeat=d)), dtype=np.int64)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    want = np.exp(np.asarray(cc(worlds))[:, 0, 0])

    pruned, report = prune_circuit(sc, ctx=ctx, threshold=0.0)
    assert report["units_after"] == report["units_before"]
    ctx2 = PipelineContext(semiring="lse-sum", fold=True)
    got = np.exp(np.asarray(ctx2.compile(pruned)(worlds))[:, 0, 0])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)

    pruned2, _ = prune_circuit(sc, ctx=ctx, threshold=1e-3)
    ctx3 = PipelineContext(semiring="lse-sum", fold=True)
    got2 = np.exp(np.asarray(ctx3.compile(pruned2)(worlds))[:, 0, 0])
    assert not np.isnan(got2).any()
    assert np.all(got2 <= want + 1e-9)


def test_multiclass_circuit_outputs_normalized():
    """num_classes > 1: the root sum emits one unit per class; each class
    is its own normalized distribution under softmax weights."""
    rng = np.random.default_rng(123)

    def softmax_const(shape):
        from cirkit_tpu.symbolic.initializers import ConstantTensorInitializer
        from cirkit_tpu.symbolic.parameters import (
            Parameter,
            SoftmaxParameter,
            TensorParameter,
        )

        t = TensorParameter(
            *shape, initializer=ConstantTensorInitializer(rng.normal(size=shape))
        )
        return Parameter.from_unary(SoftmaxParameter(shape), t)

    def input_factory(scope, num_units):
        return CategoricalLayer(
            scope, num_units, num_categories=NUM_CATS,
            probs=softmax_const((num_units, NUM_CATS)),
        )

    rg = RandomBinaryTree(5, seed=0)
    sc = rg.build_circuit(
        input_factory=input_factory,
        sum_product="cp",
        sum_weight_factory=softmax_const,
        num_input_units=2,
        num_sum_units=2,
        num_classes=3,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True)
    cc = ctx.compile(sc)
    worlds = np.array(list(itertools.product(range(NUM_CATS), repeat=5)))
    out = np.exp(np.asarray(cc(worlds)))  # (W, 1, 3)
    assert out.shape == (len(worlds), 1, 3)
    want = eval_circuit(sc, worlds)[:, 0, :]  # (W, 3)
    np.testing.assert_allclose(out[:, 0, :], want, rtol=1e-9)
    np.testing.assert_allclose(out[:, 0, :].sum(axis=0), 1.0, rtol=1e-9)


# ---------------------------------------------------------------------------
# n-ary / mixing / shuffled-child-order fuzz
# ---------------------------------------------------------------------------
# The late-r5 multiply fixes (mixing-sum kron column permutation; product
# pairing for non-scope-sorted Kronecker children) lived in structures the
# template generators above never draw: sums with arity > 1 (mixing over
# alternative partitions), arity-3 products, and product children wired in
# non-sorted scope order. This generator draws exactly those shapes; outputs
# are pinned against the enumeration oracle, and products of two
# same-structure operands (the second with independently shuffled child
# orders) against the elementwise product of oracles.


def _random_nary_circuit(
    seed: int,
    param_seed: int,
    shuffle_seed: int | None = None,
    shared_partitions: bool = False,
):
    """Random smooth+decomposable circuit with mixing sums, arity-2/3
    Hadamard/Kronecker products, and (optionally) shuffled product-child
    order. Structure is a pure function of ``seed``; parameters of
    ``param_seed``; child order of ``shuffle_seed`` (None = builder order).

    ``shared_partitions=True`` draws ONE partition per region and wires the
    mixing alternatives as distinct product layers over the SAME child
    sub-circuits — the unique-factorization shape ``are_compatible``
    requires, so such circuits can be multiplied (free mixing over distinct
    partitions is correctly rejected as incompatible)."""
    from cirkit_tpu.symbolic import Circuit, HadamardLayer, KroneckerLayer, SumLayer
    from cirkit_tpu.utils import Scope

    rng = np.random.default_rng(seed)
    prng = np.random.default_rng(param_seed)
    srng = None if shuffle_seed is None else np.random.default_rng(shuffle_seed)

    def softmax_const(shape):
        t = TensorParameter(
            *shape, initializer=ConstantTensorInitializer(prng.normal(size=shape))
        )
        return Parameter.from_unary(SoftmaxParameter(shape), t)

    layers: list = []
    in_layers: dict = {}

    def add(layer, children=()):
        layers.append(layer)
        if children:
            in_layers[layer] = list(children)
        return layer

    def build(vs: list[int], k_out: int):
        if len(vs) == 1:
            return add(
                CategoricalLayer(
                    Scope(vs), k_out, num_categories=NUM_CATS,
                    probs=softmax_const((k_out, NUM_CATS)),
                )
            )
        arity = int(min(len(vs), 2 + (rng.random() < 0.4)))
        n_parts = 1 + int(rng.random() < 0.5)
        k_child = int(rng.integers(1, 4))

        def draw_partition():
            perm = list(vs)
            rng.shuffle(perm)  # child scopes in non-sorted variable order
            cuts = sorted(rng.choice(range(1, len(vs)), size=arity - 1, replace=False))
            groups = [perm[a:b] for a, b in zip([0, *cuts], [*cuts, len(vs)])]
            return [build(g, k_child) for g in groups]

        shared = draw_partition() if shared_partitions else None
        shared_kind = rng.random() < 0.5
        part_sums = []
        for _ in range(n_parts):
            children = list(shared) if shared is not None else draw_partition()
            kind = shared_kind if shared is not None else (rng.random() < 0.5)
            if srng is not None:
                srng.shuffle(children)
            if kind:
                prod = add(HadamardLayer(k_child, arity=arity), children)
                m = k_child
            else:
                prod = add(KroneckerLayer(k_child, arity=arity), children)
                m = k_child**arity
            part_sums.append(add(SumLayer(m, k_out, weight=softmax_const((k_out, m))), [prod]))
        if n_parts == 1:
            return part_sums[0]
        # mixing sum over the alternative partitions (arity > 1)
        return add(
            SumLayer(k_out, k_out, arity=n_parts,
                     weight=softmax_const((k_out, n_parts * k_out))),
            part_sums,
        )

    n = int(rng.integers(3, 7))
    vs = list(range(n))
    rng.shuffle(vs)
    k_root = int(rng.integers(2, 4))
    top = build(vs, k_root)
    root = add(SumLayer(k_root, 1, weight=softmax_const((1, k_root))), [top])
    return Circuit(layers, in_layers, [root])


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("fold,optimize", [(False, False), (True, True)])
def test_random_nary_circuit_matches_enumeration(seed, fold, optimize):
    sc = _random_nary_circuit(seed, param_seed=seed + 500)
    assert sc.is_smooth and sc.is_decomposable
    d = sc.num_variables
    worlds = np.array(list(itertools.product(range(NUM_CATS), repeat=d)), dtype=np.int64)
    want = eval_circuit(sc, worlds)[:, 0, 0]

    ctx = PipelineContext(semiring="lse-sum", fold=fold, optimize=optimize)
    cc = ctx.compile(sc)
    got = np.exp(np.asarray(cc(worlds))[:, 0, 0])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    z = np.exp(np.asarray(ctx.integrate(cc)(ctx.parameters, worlds[:1]))[0, 0, 0])
    np.testing.assert_allclose(z, 1.0, rtol=1e-9)

    # MAP routing through mixing sums and arity-3 Kroneckers
    from cirkit_tpu.backend.jax.queries import MAPQuery
    from tests.reference_eval import max_eval_circuit

    asg, val = MAPQuery(cc)(store=ctx.parameters)
    mx = max_eval_circuit(sc, worlds)[:, 0, 0]
    best = int(np.argmax(mx))
    np.testing.assert_allclose(float(val[0]), np.log(mx[best]), rtol=1e-9)
    np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), worlds[best])


@pytest.mark.parametrize("seed", range(8))
def test_random_nary_circuit_product_matches_enumeration(seed):
    """Multiply two same-structure circuits — independent parameters, the
    second with shuffled product-child orders — and pin the product (and its
    partition function) against the elementwise product of oracles."""
    sc1 = _random_nary_circuit(seed, param_seed=seed + 500, shared_partitions=True)
    sc2 = _random_nary_circuit(
        seed, param_seed=seed + 900, shuffle_seed=seed + 77, shared_partitions=True
    )
    d = sc1.num_variables
    worlds = np.array(list(itertools.product(range(NUM_CATS), repeat=d)), dtype=np.int64)
    want = eval_circuit(sc1, worlds)[:, 0, 0] * eval_circuit(sc2, worlds)[:, 0, 0]

    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.multiply(ctx.compile(sc1), ctx.compile(sc2))
    got = np.exp(np.asarray(cc(ctx.parameters, worlds))[:, 0, 0])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    z = np.exp(np.asarray(ctx.integrate(cc)(ctx.parameters, worlds[:1]))[0, 0, 0])
    np.testing.assert_allclose(z, want.sum(), rtol=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_random_circuit_query_consistency(seed):
    """Query fuzz over the same random topologies: MAP vs the exhaustive
    max-product oracle, conditional-sampling log-evidence vs IntegrateQuery,
    expectations vs the enumerated posterior — all on the folded+optimized
    compile."""
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.queries import (
        ExpectationQuery,
        IntegrateQuery,
        MAPQuery,
        SamplingQuery,
    )
    from tests.reference_eval import enumerate_worlds, max_eval_circuit

    sc = _random_circuit(seed)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    store = ctx.parameters
    d = sc.num_variables
    worlds = enumerate_worlds(d, NUM_CATS)
    p = eval_circuit(sc, worlds)[:, 0, 0]
    mvals = max_eval_circuit(sc, worlds)[:, 0, 0]
    rng = np.random.default_rng(1000 + seed)

    # unconditional MAP == argmax of the max-product oracle
    asg, val = MAPQuery(cc)(store=store)
    best = int(np.argmax(mvals))
    np.testing.assert_array_equal(np.asarray(asg[0]).astype(int), worlds[best])
    np.testing.assert_allclose(float(val[0]), np.log(mvals[best]), rtol=1e-6)

    # random evidence rows: conditional log-evidence == enumerated marginal,
    # completions respect evidence; expectations == enumerated posterior mean
    x = worlds[rng.integers(0, len(worlds), size=4)]
    mask = rng.random((4, d)) < 0.5
    s, le = SamplingQuery(cc).conditional(
        jnp.asarray(x), evidence_mask=jnp.asarray(mask),
        key=jax.random.PRNGKey(seed), store=store,
    )
    marg = IntegrateQuery(cc)(jnp.asarray(x), integrate_vars=jnp.asarray(~mask), store=store)
    np.testing.assert_allclose(
        np.asarray(le), np.asarray(marg)[:, 0, 0], rtol=1e-5, atol=1e-8
    )
    assert np.array_equal(np.asarray(s)[mask], x[mask])

    exp = np.asarray(ExpectationQuery(cc)(jnp.asarray(x), evidence_mask=jnp.asarray(mask), store=store))
    for b in range(4):
        keep = (worlds[:, mask[b]] == x[b, mask[b]][None]).all(axis=1)
        pw = p[keep] / p[keep].sum()
        want = (pw[:, None] * worlds[keep]).sum(axis=0)
        want[mask[b]] = x[b, mask[b]]
        np.testing.assert_allclose(exp[b], want, rtol=1e-5, atol=1e-8)

    # conditional MAP == restricted enumeration
    casg, cval = MAPQuery(cc)(jnp.asarray(x), evidence_mask=jnp.asarray(mask), store=store)
    for b in range(4):
        keep = (worlds[:, mask[b]] == x[b, mask[b]][None]).all(axis=1)
        cand = np.where(keep)[0]
        cbest = cand[np.argmax(mvals[cand])]
        np.testing.assert_array_equal(np.asarray(casg[b]).astype(int), worlds[cbest])
        np.testing.assert_allclose(float(cval[b]), np.log(mvals[cbest]), rtol=1e-6)


# ---------------------------------------------------------------------------
# partial-overlap product fuzz
# ---------------------------------------------------------------------------
# Operands are restrictions of ONE random global vtree to two overlapping
# variable subsets — restrictions of a common vtree are compatible over the
# intersection by construction, so every draw must multiply. Kinds
# (Hadamard/Kronecker), unit widths, and child orders vary independently
# per operand.


def _restrict_tree(tree, keep):
    if isinstance(tree, int):
        return tree if tree in keep else None
    left, right = _restrict_tree(tree[0], keep), _restrict_tree(tree[1], keep)
    if left is None:
        return right
    if right is None:
        return left
    return (left, right)


def _tree_pc(tree, k, param_seed, wire_seed):
    from cirkit_tpu.symbolic import Circuit, HadamardLayer, KroneckerLayer, SumLayer
    from cirkit_tpu.utils import Scope

    prng = np.random.default_rng(param_seed)
    wrng = np.random.default_rng(wire_seed)

    def softmax_const(shape):
        t = TensorParameter(
            *shape, initializer=ConstantTensorInitializer(prng.normal(size=shape))
        )
        return Parameter.from_unary(SoftmaxParameter(shape), t)

    layers, in_layers = [], {}

    def add(layer, children=()):
        layers.append(layer)
        if children:
            in_layers[layer] = list(children)
        return layer

    def build(node):
        if isinstance(node, int):
            return add(
                CategoricalLayer(
                    Scope([node]), k, num_categories=NUM_CATS,
                    probs=softmax_const((k, NUM_CATS)),
                )
            )
        children = [build(node[0]), build(node[1])]
        if wrng.random() < 0.5:
            children.reverse()
        if wrng.random() < 0.5:
            prod = add(HadamardLayer(k, arity=2), children)
            m = k
        else:
            prod = add(KroneckerLayer(k, arity=2), children)
            m = k * k
        return add(SumLayer(m, k, weight=softmax_const((k, m))), [prod])

    top = build(tree)
    root = add(SumLayer(k, 1, weight=softmax_const((1, k))), [top])
    return Circuit(layers, in_layers, [root])


@pytest.mark.parametrize("seed", range(10))
def test_partial_overlap_product_fuzz(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 6))
    vs = list(range(n))
    rng.shuffle(vs)

    def gen(vs):
        if len(vs) == 1:
            return vs[0]
        cut = int(rng.integers(1, len(vs)))
        return (gen(vs[:cut]), gen(vs[cut:]))

    tree = gen(vs)
    while True:
        keep1 = {v for v in range(n) if rng.random() < 0.7}
        keep2 = {v for v in range(n) if rng.random() < 0.7}
        if (
            keep1 and keep2 and (keep1 & keep2)
            and (keep1 | keep2) == set(range(n)) and keep1 != keep2
        ):
            break
    sc1 = _tree_pc(_restrict_tree(tree, keep1), int(rng.integers(1, 4)), seed + 31, seed + 41)
    sc2 = _tree_pc(_restrict_tree(tree, keep2), int(rng.integers(1, 4)), seed + 51, seed + 61)

    worlds = np.array(list(itertools.product(range(NUM_CATS), repeat=n)), dtype=np.int64)
    want = eval_circuit(sc1, worlds)[:, 0, 0] * eval_circuit(sc2, worlds)[:, 0, 0]

    import cirkit_tpu.symbolic.functional as SF

    psc = SF.multiply(sc1, sc2)
    assert psc.scope == set(range(n)) or tuple(sorted(psc.scope)) == tuple(range(n))
    assert psc.is_smooth and psc.is_decomposable
    np.testing.assert_allclose(
        eval_circuit(psc, worlds)[:, 0, 0], want, rtol=1e-9, atol=1e-12
    )

    for fold, optimize in [(False, False), (True, True)]:
        ctx = PipelineContext(semiring="lse-sum", fold=fold, optimize=optimize)
        cc = ctx.multiply(ctx.compile(sc1), ctx.compile(sc2))
        got = np.exp(np.asarray(cc(ctx.parameters, worlds))[:, 0, 0])
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        z = np.exp(np.asarray(ctx.integrate(cc)(ctx.parameters, worlds[:1]))[0, 0, 0])
        np.testing.assert_allclose(z, want.sum(), rtol=1e-9)

    # MAP on the (unnormalized) product: routing through the broadcast
    # selection sums and distribute layers
    from cirkit_tpu.backend.jax.queries import MAPQuery
    from tests.reference_eval import max_eval_circuit

    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.multiply(ctx.compile(sc1), ctx.compile(sc2))
    asg, val = MAPQuery(cc)(store=ctx.parameters)
    mx = max_eval_circuit(psc, worlds)[:, 0, 0]
    best = int(np.argmax(mx))
    np.testing.assert_allclose(float(val[0]), np.log(mx[best]), rtol=1e-9)
