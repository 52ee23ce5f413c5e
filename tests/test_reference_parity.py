"""Head-to-head parity against the actual reference backend.

BASELINE.json's first target is "LL parity <=1e-4 nats with the torch
backend". These tests prove it directly (far past the target, at f64
precision): the SAME symbolic circuit with the SAME constant parameter
values is built with both frameworks' IRs (the class names and signatures
are intentionally identical), compiled by both backends (reference:
``/root/reference/cirkit/pipeline.py:134`` ->
``cirkit/backend/torch/compiler.py:109``; ours: ``cirkit_tpu.pipeline``),
and the outputs, partition functions and operator pipelines
(integrate / multiply / conjugate / differentiate) are compared.

The reference runs on CPU torch in float64 with autograd off; ours runs
on CPU jax with x64 enabled (tests/conftest.py). Tolerances are 1e-9 —
four orders past the 1e-4 nats target.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # imports and runs the torch reference backend

REFERENCE_PATH = "/root/reference"
if not os.path.isdir(os.path.join(REFERENCE_PATH, "cirkit")):
    pytest.skip("reference tree unavailable", allow_module_level=True)
if REFERENCE_PATH not in sys.path:
    sys.path.insert(0, REFERENCE_PATH)
torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def _torch_f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    with torch.no_grad():
        yield
    torch.set_default_dtype(prev)


def _ref_api():
    import cirkit.symbolic.functional as F
    from cirkit.pipeline import PipelineContext
    from cirkit.symbolic import initializers as I
    from cirkit.symbolic import layers as L
    from cirkit.symbolic import parameters as P
    from cirkit.symbolic.circuit import Circuit
    from cirkit.utils.scope import Scope

    return SimpleNamespace(
        kind="ref", L=L, P=P, I=I, F=F, Circuit=Circuit, Scope=Scope, Ctx=PipelineContext
    )


def _jax_api():
    import cirkit_tpu.symbolic.functional as F
    from cirkit_tpu.pipeline import PipelineContext
    from cirkit_tpu.symbolic import initializers as I
    from cirkit_tpu.symbolic import layers as L
    from cirkit_tpu.symbolic import parameters as P
    from cirkit_tpu.symbolic.circuit import Circuit
    from cirkit_tpu.utils.scope import Scope

    return SimpleNamespace(
        kind="jax", L=L, P=P, I=I, F=F, Circuit=Circuit, Scope=Scope, Ctx=PipelineContext
    )


def _const(api, arr, *, softmax=False, learnable=True):
    arr = np.asarray(arr)
    tp = api.P.TensorParameter(
        *arr.shape,
        initializer=api.I.ConstantTensorInitializer(arr),
        learnable=learnable,
    )
    if softmax:
        return api.P.Parameter.from_unary(api.P.SoftmaxParameter(arr.shape), tp)
    return api.P.Parameter.from_input(tp)


def _make_ctx(api, semiring, fold=True, optimize=True):
    if api.kind == "ref":
        return api.Ctx(backend="torch", semiring=semiring, fold=fold, optimize=optimize)
    return api.Ctx(semiring=semiring, fold=fold, optimize=optimize)


def _run(api, ctx, cc, x):
    """Evaluate a compiled circuit on integer/real worlds, return (B, O, K)."""
    if api.kind == "ref":
        return cc(torch.as_tensor(x)).detach().cpu().numpy()
    store = getattr(ctx, "parameters", None)
    return np.asarray(cc(x)) if store is None else np.asarray(cc.jit_evaluate(store, x))


# ---------------------------------------------------------------------------
# shared circuit builders (one body, both IRs)
# ---------------------------------------------------------------------------


def _values_cp(rng, K=4, N=3):
    return {
        "logits": [rng.standard_normal((K, N)) for _ in range(4)],
        "w01": rng.standard_normal((K, K)),
        "w01b": rng.standard_normal((K, K)),
        "w23": rng.standard_normal((K, K)),
        "mix": rng.standard_normal((K, 2 * K)),
        "root": rng.standard_normal((1, K)),
    }


def _build_cp_pc(api, v, mixing=True):
    """4-var categorical CP circuit: inputs -> Hadamard pairs -> softmax
    Sums (two parallel heads over {0,1}, joined by an arity-2 mixing sum)
    -> top Hadamard -> softmax root sum. ``mixing=False`` drops the second
    head and keeps ``mix`` arity-1 — use that variant for head-to-head
    PRODUCT pipelines: the reference's ``multiply`` mis-orders the kron'd
    weight columns for arity>1 x arity>1 sum products (see
    ``test_mixing_product_diverges_from_reference``)."""
    K, N = v["logits"][0].shape
    inputs = [
        api.L.CategoricalLayer(
            api.Scope([i]), K, num_categories=N, logits=_const(api, v["logits"][i])
        )
        for i in range(4)
    ]
    h01, h23 = api.L.HadamardLayer(K, arity=2), api.L.HadamardLayer(K, arity=2)
    s01 = api.L.SumLayer(K, K, weight=_const(api, v["w01"], softmax=True))
    s23 = api.L.SumLayer(K, K, weight=_const(api, v["w23"], softmax=True))
    top = api.L.HadamardLayer(K, arity=2)
    root = api.L.SumLayer(K, 1, weight=_const(api, v["root"], softmax=True))
    if mixing:
        s01b = api.L.SumLayer(K, K, weight=_const(api, v["w01b"], softmax=True))
        mix = api.L.SumLayer(K, K, arity=2, weight=_const(api, v["mix"], softmax=True))
        mid_layers, mid_in = [s01b, mix], {s01b: [h01], mix: [s01, s01b]}
        mid_top = mix
    else:
        mid_layers, mid_in = [], {}
        mid_top = s01
    return api.Circuit(
        [*inputs, h01, h23, s01, *mid_layers, s23, top, root],
        {
            h01: [inputs[0], inputs[1]],
            h23: [inputs[2], inputs[3]],
            s01: [h01],
            **mid_in,
            s23: [h23],
            top: [mid_top, s23],
            root: [top],
        },
        [root],
    )


def _values_tucker(rng, K=3, N=3):
    return {
        "logits": [rng.standard_normal((K, N)) for _ in range(2)],
        "core": rng.standard_normal((1, K * K)),
    }


def _build_tucker_pc(api, v, reverse=False):
    """``reverse=True`` wires the Kronecker children in non-scope-sorted
    order. Both frameworks honor the wiring order (first-child-major kron
    digits). The reference's compatibility check is child-ORDER-sensitive
    (its scope "sort" uses the subset partial order — a stable no-op for
    disjoint siblings), so it REJECTS mixed-order products; we pair by
    scope and correct the Kronecker digit order, so they multiply (see
    ``test_kronecker_child_order_product_beyond_reference``)."""
    K, N = v["logits"][0].shape
    inputs = [
        api.L.CategoricalLayer(
            api.Scope([i]), K, num_categories=N, logits=_const(api, v["logits"][i])
        )
        for i in range(2)
    ]
    kron = api.L.KroneckerLayer(K, arity=2)
    root = api.L.SumLayer(K * K, 1, weight=_const(api, v["core"], softmax=True))
    kids = [inputs[1], inputs[0]] if reverse else [inputs[0], inputs[1]]
    return api.Circuit(
        [*inputs, kron, root],
        {kron: kids, root: [kron]},
        [root],
    )


def _values_gaussian(rng, K=3):
    return {
        "mean": [rng.standard_normal((K,)) for _ in range(2)],
        "stddev": [rng.uniform(0.5, 2.0, (K,)) for _ in range(2)],
        "w": rng.dirichlet(np.ones(K))[None],
    }


def _build_gaussian_pc(api, v):
    K = v["mean"][0].shape[0]
    inputs = [
        api.L.GaussianLayer(
            api.Scope([i]),
            K,
            mean=_const(api, v["mean"][i]),
            stddev=_const(api, v["stddev"][i]),
        )
        for i in range(2)
    ]
    h = api.L.HadamardLayer(K, arity=2)
    root = api.L.SumLayer(K, 1, weight=_const(api, v["w"]))
    return api.Circuit(
        [*inputs, h, root], {h: [inputs[0], inputs[1]], root: [h]}, [root]
    )


def _values_embedding(rng, K=3, N=2):
    # possibly-negative weights: the non-monotonic SoS ingredient
    return {
        "weight": [rng.standard_normal((K, N)) for _ in range(2)],
        "w": rng.standard_normal((1, K)),
    }


def _build_embedding_pc(api, v):
    K, N = v["weight"][0].shape
    inputs = [
        api.L.EmbeddingLayer(
            api.Scope([i]), K, num_states=N, weight=_const(api, v["weight"][i])
        )
        for i in range(2)
    ]
    h = api.L.HadamardLayer(K, arity=2)
    root = api.L.SumLayer(K, 1, weight=_const(api, v["w"]))
    return api.Circuit(
        [*inputs, h, root], {h: [inputs[0], inputs[1]], root: [h]}, [root]
    )


def _scalar(out):
    """First element of a (possibly batchless) output: the ref backend
    returns (O, K) for fully-integrated circuits while ours keeps (B, O, K)."""
    return np.asarray(out).reshape(-1)[0]


def _worlds(num_vars, num_states):
    import itertools

    return np.array(
        list(itertools.product(range(num_states), repeat=num_vars)), dtype=np.int64
    )


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("optimize", [False, True])
def test_categorical_cp_forward_and_partition(fold, optimize):
    v = _values_cp(np.random.default_rng(0))
    worlds = _worlds(4, 3)
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, "lse-sum", fold=fold, optimize=optimize)
        cc = ctx.compile(_build_cp_pc(api, v))
        outs[api.kind] = _run(api, ctx, cc, worlds)[:, 0, 0]
        icc = ctx.integrate(cc)
        outs[api.kind + "_z"] = float(_scalar(_run(api, ctx, icc, worlds[:1])))
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs["jax_z"], outs["ref_z"], rtol=1e-9, atol=1e-9)
    # the partition function matches the exhaustive enumeration too
    enum_z = np.log(np.exp(outs["ref"]).sum())
    np.testing.assert_allclose(outs["ref_z"], enum_z, rtol=1e-9)


def test_tucker_kronecker_parity():
    v = _values_tucker(np.random.default_rng(1))
    worlds = _worlds(2, 3)
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, "lse-sum")
        cc = ctx.compile(_build_tucker_pc(api, v))
        outs[api.kind] = _run(api, ctx, cc, worlds)[:, 0, 0]
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)


def test_gaussian_forward_and_partition_parity():
    v = _values_gaussian(np.random.default_rng(2))
    pts = np.random.default_rng(3).standard_normal((16, 2))
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, "lse-sum")
        cc = ctx.compile(_build_gaussian_pc(api, v))
        outs[api.kind] = _run(api, ctx, cc, pts)[:, 0, 0]
        icc = ctx.integrate(cc)
        outs[api.kind + "_z"] = float(_scalar(_run(api, ctx, icc, pts[:1])))
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs["jax_z"], outs["ref_z"], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("semiring", ["lse-sum", "sum-product"])
def test_product_integrate_pipeline_parity(semiring):
    """multiply(c1, c2) then integrate: the expectation-style operator
    pipeline, with parameters shared into the derived circuits."""
    rng = np.random.default_rng(4)
    v1, v2 = _values_cp(rng), _values_cp(rng)
    worlds = _worlds(4, 3)
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, semiring)
        # mixing=False: on arity>1 x arity>1 sum products the reference is
        # wrong (test_mixing_product_diverges_from_reference), so the
        # head-to-head covers the part both get right
        cc1 = ctx.compile(_build_cp_pc(api, v1, mixing=False))
        cc2 = ctx.compile(_build_cp_pc(api, v2, mixing=False))
        pcc = ctx.multiply(cc1, cc2)
        outs[api.kind] = _run(api, ctx, pcc, worlds)[:, 0, 0]
        icc = ctx.integrate(pcc)
        outs[api.kind + "_z"] = float(_scalar(_run(api, ctx, icc, worlds[:1])))
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs["jax_z"], outs["ref_z"], rtol=1e-9, atol=1e-9)


def test_mixing_product_diverges_from_reference():
    """Products of circuits with arity-2 mixing sums: the reference's
    ``multiply_sum_layers`` (ref ``symbolic/operators.py:260-270``) takes a
    plain Kronecker of the weights, whose columns run (a1, i1, a2, i2),
    while its product recursion wires the children in ``itertools.product``
    order (a1, a2, i1, i2) — measured up to 17% relative error vs
    enumeration. Our rule inserts the aligning column permutation: assert
    we match the brute-force ground truth and the reference does NOT (if a
    future reference release fixes the bug, the second assert flags it so
    this test can fold back into the head-to-head)."""
    from tests.reference_eval import eval_circuit as _oracle

    rng = np.random.default_rng(4)
    v1, v2 = _values_cp(rng), _values_cp(rng)
    worlds = _worlds(4, 3)

    japi = _jax_api()
    truth = (
        _oracle(_build_cp_pc(japi, v1), worlds)[:, 0, 0]
        * _oracle(_build_cp_pc(japi, v2), worlds)[:, 0, 0]
    )
    outs = {}
    for api in (_ref_api(), japi):
        ctx = _make_ctx(api, "lse-sum")
        cc1 = ctx.compile(_build_cp_pc(api, v1))
        cc2 = ctx.compile(_build_cp_pc(api, v2))
        pcc = ctx.multiply(cc1, cc2)
        outs[api.kind] = np.exp(
            np.asarray(_run(api, ctx, pcc, worlds))[:, 0, 0].astype(np.float64)
        )
    np.testing.assert_allclose(outs["jax"], truth, rtol=1e-9)
    assert np.max(np.abs(outs["ref"] - truth) / truth) > 1e-3


def test_kronecker_child_order_product_beyond_reference():
    """Multiply two Tucker circuits whose Kronecker layers wire children
    in DIFFERENT orders (one scope-sorted, one reversed). The reference
    REJECTS this as incompatible (its compatibility check compares
    factorization part-tuples in each circuit's own child order); we pair
    children by scope and post-compose a digit-order correction, so the
    product compiles and matches brute force. Also pins the both-reversed
    case head-to-head: there both frameworks agree (positional own-order
    pairing is correct when the orders coincide)."""
    from tests.reference_eval import eval_circuit as _oracle

    rng = np.random.default_rng(9)
    v1, v2 = _values_tucker(rng), _values_tucker(rng)
    worlds = _worlds(2, v1["logits"][0].shape[1])

    japi = _jax_api()
    truth = (
        _oracle(_build_tucker_pc(japi, v1, reverse=True), worlds)[:, 0, 0]
        * _oracle(_build_tucker_pc(japi, v2), worlds)[:, 0, 0]
    )
    # mixed order: ours multiplies correctly, the reference refuses
    ctx = _make_ctx(japi, "lse-sum")
    cc1 = ctx.compile(_build_tucker_pc(japi, v1, reverse=True))
    cc2 = ctx.compile(_build_tucker_pc(japi, v2))
    got = np.exp(
        np.asarray(_run(japi, ctx, ctx.multiply(cc1, cc2), worlds))[:, 0, 0].astype(
            np.float64
        )
    )
    np.testing.assert_allclose(got, truth, rtol=1e-9)

    rapi = _ref_api()
    rctx = _make_ctx(rapi, "lse-sum")
    rcc1 = rctx.compile(_build_tucker_pc(rapi, v1, reverse=True))
    rcc2 = rctx.compile(_build_tucker_pc(rapi, v2))
    from cirkit.symbolic.circuit import StructuralPropertyError as RefSPE

    with pytest.raises(RefSPE):
        rctx.multiply(rcc1, rcc2)

    # both-reversed: both frameworks accept and agree with brute force
    truth_rr = (
        _oracle(_build_tucker_pc(japi, v1, reverse=True), worlds)[:, 0, 0]
        * _oracle(_build_tucker_pc(japi, v2, reverse=True), worlds)[:, 0, 0]
    )
    outs = {}
    for api in (rapi, japi):
        actx = _make_ctx(api, "lse-sum")
        a1 = actx.compile(_build_tucker_pc(api, v1, reverse=True))
        a2 = actx.compile(_build_tucker_pc(api, v2, reverse=True))
        outs[api.kind] = np.exp(
            np.asarray(_run(api, actx, actx.multiply(a1, a2), worlds))[:, 0, 0].astype(
                np.float64
            )
        )
    np.testing.assert_allclose(outs["jax"], truth_rr, rtol=1e-9)
    np.testing.assert_allclose(outs["ref"], truth_rr, rtol=1e-9)


def test_sos_conjugate_multiply_parity():
    """Sum-of-squares: multiply(conjugate(c), c) under the complex
    log-semiring with non-monotonic (negative) embedding weights."""
    v = _values_embedding(np.random.default_rng(5))
    worlds = _worlds(2, 2)
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, "complex-lse-sum")
        cc = ctx.compile(_build_embedding_pc(api, v))
        ccj = ctx.conjugate(cc)
        sq = ctx.multiply(ccj, cc)
        out = _run(api, ctx, sq, worlds)[:, 0, 0]
        icc = ctx.integrate(sq)
        z = _scalar(_run(api, ctx, icc, worlds[:1]))
        outs[api.kind], outs[api.kind + "_z"] = out, complex(z)
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs["jax_z"], outs["ref_z"], rtol=1e-9, atol=1e-9)
    # squared circuits are real and nonnegative: exp(out) real part > 0
    sq_vals = np.exp(outs["ref"])
    assert np.all(np.abs(sq_vals.imag) < 1e-12) and np.all(sq_vals.real >= 0)


def test_polynomial_differentiate_parity():
    rng = np.random.default_rng(6)
    coeff = rng.standard_normal((1, 4))  # one unit, degree 3
    pts = np.linspace(-2.0, 2.0, 9)[:, None]
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, "sum-product")
        p = api.L.PolynomialLayer(api.Scope([0]), 1, degree=3, coeff=_const(api, coeff))
        s = api.L.SumLayer(1, 1, weight=_const(api, np.ones((1, 1))))
        sc = api.Circuit([p, s], {s: [p]}, [s])
        cc = ctx.compile(sc)
        dcc = ctx.differentiate(cc)
        outs[api.kind] = _run(api, ctx, cc, pts)[:, 0, 0]
        outs[api.kind + "_d"] = _run(api, ctx, dcc, pts)[:, 0, 0]
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(outs["jax_d"], outs["ref_d"], rtol=1e-9, atol=1e-12)


def test_evidence_integrate_parity():
    """evidence() pins variables to observations; integrating the rest
    gives the marginal — compare both backends end to end."""
    v = _values_cp(np.random.default_rng(7))
    worlds = _worlds(4, 3)
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, "lse-sum")
        sc = _build_cp_pc(api, v)
        # marginalize vars {2, 3}: integrate subset scope
        msc = api.F.integrate(sc, scope=api.Scope([2, 3]))
        mcc = ctx.compile(msc)
        outs[api.kind] = _run(api, ctx, mcc, worlds)[:, 0, 0]
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("sum_product", ["cp", "tucker"])
def test_quadgraph_flagship_structure_parity(sum_product):
    """The flagship config's structure: QuadGraph region graph -> circuit
    (cp / tucker) in both frameworks, with order-insensitive deterministic
    parameters — input logits keyed by variable, sum weights keyed by shape
    (identical for equal shapes, so any layer-creation-order difference
    between the frameworks cannot alias the comparison)."""
    K = 4
    outs = {}
    for api in (_ref_api(), _jax_api()):
        if api.kind == "ref":
            from cirkit.templates.region_graph import QuadGraph
        else:
            from cirkit_tpu.models.region_graph import QuadGraph

        def input_factory(scope, num_units, api=api):
            (var,) = tuple(scope)
            rng = np.random.default_rng(1000 + var)
            return api.L.CategoricalLayer(
                scope,
                num_units,
                num_categories=4,
                logits=_const(api, rng.standard_normal((num_units, 4))),
            )

        def weight_factory(shape, api=api):
            rng = np.random.default_rng(hash(tuple(shape)) % (2**31))
            return _const(api, rng.standard_normal(shape), softmax=True)

        rg = QuadGraph((1, 4, 4))
        sc = rg.build_circuit(
            input_factory=input_factory,
            sum_product=sum_product,
            sum_weight_factory=weight_factory,
            nary_sum_weight_factory=weight_factory,
            num_input_units=K,
            num_sum_units=K,
        )
        ctx = _make_ctx(api, "lse-sum")
        cc = ctx.compile(sc)
        x = np.random.default_rng(9).integers(0, 4, size=(16, 16)).astype(np.int64)
        outs[api.kind] = _run(api, ctx, cc, x)[:, 0, 0]
        icc = ctx.integrate(cc)
        outs[api.kind + "_z"] = float(_scalar(_run(api, ctx, icc, x[:1])))
        outs[api.kind + "_types"] = sorted(
            type(l).__name__ for l in sc.topological_ordering()
        )
    assert outs["jax_types"] == outs["ref_types"]
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs["jax_z"], outs["ref_z"], rtol=1e-9, atol=1e-9)


def test_signed_semiring_sos_parity_with_reference_complex():
    """The signed-lse-sum semiring (this repo's all-real SoS path; the
    reference has no analogue) must agree with the reference torch backend
    running the same squared circuit under its complex semiring."""
    v = _values_embedding(np.random.default_rng(9))
    worlds = _worlds(2, 2)

    rapi = _ref_api()
    rctx = _make_ctx(rapi, "complex-lse-sum")
    rcc = rctx.compile(_build_embedding_pc(rapi, v))
    rsq = rctx.multiply(rctx.conjugate(rcc), rcc)
    ref_vals = np.exp(_run(rapi, rctx, rsq, worlds)[:, 0, 0]).real
    ref_z = np.exp(complex(_scalar(_run(rapi, rctx, rctx.integrate(rsq), worlds[:1])))).real

    japi = _jax_api()
    jctx = _make_ctx(japi, "signed-lse-sum")
    jcc = jctx.compile(_build_embedding_pc(japi, v))
    jsq = jctx.multiply(jctx.conjugate(jcc), jcc)
    logmag, sign = jsq.jit_evaluate(jctx.parameters, worlds)
    got = np.asarray(sign)[:, 0, 0] * np.exp(np.asarray(logmag)[:, 0, 0])
    za, zs = jctx.integrate(jsq).jit_evaluate(jctx.parameters, worlds[:1])
    got_z = float(zs[0, 0, 0]) * np.exp(float(za[0, 0, 0]))

    np.testing.assert_allclose(got, ref_vals, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got_z, ref_z, rtol=1e-9)


# ---------------------------------------------------------------------------
# head-to-head randomized fuzz (VERDICT r4 item 8)
# ---------------------------------------------------------------------------
# The fixed fixtures above pin known shapes; these cases draw random
# structures (random binary scope tree x cp/tucker blocks x unit counts x
# operator pipeline x semiring) from a seed and build the SAME circuit in
# both IRs — catching shared-blind-spot semantics drift the own-enumeration
# fuzz grid (tests/test_fuzz_circuits.py) cannot see. Harness pattern after
# the reference's randomized compile tests
# (/root/reference/tests/backend/torch/test_compile_circuit.py:76-91).


def _fuzz_desc(seed):
    """Deterministic random structure description: returns (tree, num_vars,
    num_states, pipeline, semiring). Tree nodes: ("leaf", var, k) or
    ("node", kind, k_out, k_child, left, right)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 6))
    states = int(rng.integers(2, 4))

    def gen(vs, k_out):
        if len(vs) == 1:
            return ("leaf", vs[0], k_out)
        cut = int(rng.integers(1, len(vs)))
        kind = ["cp", "tucker"][int(rng.integers(0, 2))]
        k_child = int(rng.integers(2, 5))
        return (
            "node", kind, k_out, k_child,
            gen(vs[:cut], k_child), gen(vs[cut:], k_child),
        )

    k_root = int(rng.integers(2, 5))
    tree = gen(list(range(n)), k_root)
    pipeline = ["plain", "integrate", "multiply", "multiply_integrate"][
        int(rng.integers(0, 4))
    ]
    semiring = ["lse-sum", "sum-product"][int(rng.integers(0, 2))]
    int_subset = [v for v in range(n) if rng.random() < 0.5]
    if not int_subset:
        int_subset = [0]
    return tree, n, states, pipeline, semiring, int_subset


def _fuzz_values(tree, states, seed):
    """Per-node parameter draws, keyed by a deterministic traversal index."""
    rng = np.random.default_rng(seed)
    vals = {}
    idx = [0]

    def walk(node):
        i = idx[0]
        idx[0] += 1
        if node[0] == "leaf":
            _, _, k = node
            vals[i] = rng.standard_normal((k, states))
            return k
        _, kind, k_out, k_child, left, right = node
        walk(left)
        walk(right)
        m = k_child * k_child if kind == "tucker" else k_child
        vals[i] = rng.standard_normal((k_out, m))
        return k_out

    k_root = walk(tree)
    vals["root"] = rng.standard_normal((1, k_root))
    return vals


def _build_fuzz(api, tree, states, vals):
    layers, in_layers = [], {}
    idx = [0]

    def build(node):
        i = idx[0]
        idx[0] += 1
        if node[0] == "leaf":
            _, var, k = node
            layer = api.L.CategoricalLayer(
                api.Scope([var]), k, num_categories=states,
                logits=_const(api, vals[i]),
            )
            layers.append(layer)
            return layer
        _, kind, k_out, k_child, left, right = node
        lc, rc = build(left), build(right)
        if kind == "cp":
            prod = api.L.HadamardLayer(k_child, arity=2)
        else:
            prod = api.L.KroneckerLayer(k_child, arity=2)
        m = k_child * k_child if kind == "tucker" else k_child
        s = api.L.SumLayer(m, k_out, weight=_const(api, vals[i], softmax=True))
        layers.extend([prod, s])
        in_layers[prod] = [lc, rc]
        in_layers[s] = [prod]
        return s

    top = build(tree)
    root = api.L.SumLayer(
        top.num_output_units, 1, weight=_const(api, vals["root"], softmax=True)
    )
    layers.append(root)
    in_layers[root] = [top]
    return api.Circuit(layers, in_layers, [root])


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_head_to_head_vs_reference(seed):
    tree, n, states, pipeline, semiring, int_subset = _fuzz_desc(seed)
    vals = _fuzz_values(tree, states, seed + 10_000)
    vals2 = _fuzz_values(tree, states, seed + 20_000)
    worlds = _worlds(n, states)
    outs = {}
    for api in (_ref_api(), _jax_api()):
        ctx = _make_ctx(api, semiring)
        sc = _build_fuzz(api, tree, states, vals)
        if pipeline == "integrate":
            sc = api.F.integrate(sc, scope=api.Scope(int_subset))
            cc = ctx.compile(sc)
        elif pipeline in ("multiply", "multiply_integrate"):
            cc1 = ctx.compile(sc)
            cc2 = ctx.compile(_build_fuzz(api, tree, states, vals2))
            cc = ctx.multiply(cc1, cc2)
            if pipeline == "multiply_integrate":
                cc = ctx.integrate(cc)
        else:
            cc = ctx.compile(sc)
        outs[api.kind] = _run(api, ctx, cc, worlds)[:, 0, 0]
        if pipeline == "plain":
            icc = ctx.integrate(cc)
            outs[api.kind + "_z"] = float(_scalar(_run(api, ctx, icc, worlds[:1])))
    np.testing.assert_allclose(outs["jax"], outs["ref"], rtol=1e-9, atol=1e-9)
    if pipeline == "plain":
        np.testing.assert_allclose(outs["jax_z"], outs["ref_z"], rtol=1e-9, atol=1e-9)
