"""Signed log-semiring tests: the all-real alternative to the
complex semiring for circuits with real parameters but possibly-negative
values — squared/SoS circuits, differentials (new capability; the reference
evaluates these under complex, ``backend/torch/semiring.py:411-476``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cirkit_tpu.symbolic.functional as SF
from cirkit_tpu.pipeline import PipelineContext
from cirkit_tpu.utils.scope import Scope

from tests.backend.test_sos import _const, _nonmonotonic_pc
from tests.reference_eval import enumerate_worlds, eval_circuit


@pytest.mark.parametrize("fold", [False, True])
def test_signed_semiring_evaluates_negative_outputs(fold):
    sc = _nonmonotonic_pc()
    ctx = PipelineContext(semiring="signed-lse-sum", fold=fold)
    cc = ctx.compile(sc)
    worlds = enumerate_worlds(2, 3)
    logmag, sign = cc(worlds)
    got = np.asarray(sign)[:, 0, 0] * np.exp(np.asarray(logmag)[:, 0, 0])
    want = eval_circuit(sc, worlds)[:, 0, 0]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("fold,optimize", [(False, False), (True, False), (True, True)])
def test_signed_squared_circuit_matches_complex(fold, optimize):
    """|c|^2 via multiply(conjugate(c), c): the signed compile must agree
    with the complex-semiring compile on outputs and partition function."""
    sc = _nonmonotonic_pc()
    worlds = enumerate_worlds(2, 3)

    outs = {}
    for semiring in ("signed-lse-sum", "complex-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=fold, optimize=optimize)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        zc = ctx.integrate(sq)
        out = sq(worlds)
        z = zc(worlds[:1])
        if semiring == "signed-lse-sum":
            (a, s), (za, zs) = out, z
            outs[semiring] = (
                np.asarray(s)[:, 0, 0] * np.exp(np.asarray(a)[:, 0, 0]),
                float(zs[0, 0, 0]) * np.exp(float(za[0, 0, 0])),
            )
        else:
            outs[semiring] = (
                np.exp(np.asarray(out)[:, 0, 0]).real,
                np.exp(complex(z[0, 0, 0])).real,
            )

    want = eval_circuit(sc, worlds)[:, 0, 0] ** 2
    for semiring, (got, z) in outs.items():
        np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=semiring)
        np.testing.assert_allclose(z, want.sum(), rtol=1e-9, err_msg=semiring)


@pytest.mark.slow
def test_signed_gradients_match_complex():
    """MLE gradients of the squared-circuit NLL under the signed semiring
    equal the complex-semiring ones (real parts) — same loss landscape."""
    sc = _nonmonotonic_pc()
    worlds = enumerate_worlds(2, 3)

    grads = {}
    for semiring in ("signed-lse-sum", "complex-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=True)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        zc = ctx.integrate(sq)
        store = {k: v for k, v in ctx.parameters.items()}
        # the squared circuit reads its operand's tensors through pointer
        # slots; differentiate w.r.t. the original circuit's parameters
        tr = {k: v for k, v in store.items() if k in cc.learnable_slots}
        fr = {k: v for k, v in store.items() if k not in tr}

        def loss(tr):
            st = {**tr, **fr}
            ll = sq.evaluate(st, worlds)
            z = zc.evaluate(st, worlds[:1])
            if semiring == "signed-lse-sum":
                return -jnp.mean(ll[0]) + z[0][0, 0, 0]
            return -jnp.mean(ll.real) + z.real[0, 0, 0]

        grads[semiring] = jax.grad(loss)(tr)

    gs, gc = grads["signed-lse-sum"], grads["complex-lse-sum"]
    assert set(gs) == set(gc) and gs
    for k in gs:
        np.testing.assert_allclose(
            np.asarray(gs[k]), np.asarray(gc[k]).real, rtol=1e-8, atol=1e-12,
            err_msg=k,
        )


def test_signed_differentiated_circuit():
    """d/dx of a (Gaussian-free, categorical) circuit takes negative values;
    the signed semiring evaluates the polynomial differential circuits the
    reference routes through complex."""
    from cirkit_tpu.symbolic.circuit import Circuit
    from cirkit_tpu.symbolic.layers import HadamardLayer, PolynomialLayer, SumLayer

    rng = np.random.default_rng(44)
    p0 = PolynomialLayer(Scope([0]), 2, degree=2, coeff=_const(rng.normal(size=(2, 3))))
    p1 = PolynomialLayer(Scope([1]), 2, degree=2, coeff=_const(rng.normal(size=(2, 3))))
    h = HadamardLayer(2, arity=2)
    s = SumLayer(2, 1, weight=_const([[0.8, 0.4]]))
    sc = Circuit([p0, p1, h, s], {h: [p0, p1], s: [h]}, [s])
    dsc = SF.differentiate(sc)

    ctx = PipelineContext(semiring="signed-lse-sum", fold=True)
    dcc = ctx.compile(dsc)
    x = rng.normal(size=(5, 2))
    a, s_ = dcc(x)
    got = np.asarray(s_) * np.exp(np.asarray(a))

    # finite-difference ground truth per variable
    eps = 1e-6
    base = eval_circuit(sc, x)[:, 0, 0]
    for v in range(2):
        xp = x.copy()
        xp[:, v] += eps
        fd = (eval_circuit(sc, xp)[:, 0, 0] - base) / eps
        np.testing.assert_allclose(got[:, v, 0], fd, rtol=1e-4, atol=1e-6)


def test_signed_integrate_query():
    """Runtime-mask marginals under the signed semiring."""
    from cirkit_tpu.backend.jax.queries import IntegrateQuery

    sc = _nonmonotonic_pc()
    ctx = PipelineContext(semiring="signed-lse-sum", fold=True)
    cc = ctx.compile(sc)
    sq = ctx.multiply(ctx.conjugate(cc), cc)
    worlds = enumerate_worlds(2, 3)
    a, s = IntegrateQuery(sq)(worlds, integrate_vars=Scope([1]))
    got = np.asarray(s)[:, 0, 0] * np.exp(np.asarray(a)[:, 0, 0])

    sq_vals = eval_circuit(sc, worlds)[:, 0, 0] ** 2
    # marginal over x1: sum the squared circuit over x1 for each x0
    want = sq_vals.reshape(3, 3).sum(axis=1)
    np.testing.assert_allclose(got.reshape(3, 3)[:, 0], want, rtol=1e-9)
    np.testing.assert_allclose(got.reshape(3, 3)[:, 1], want, rtol=1e-9)


@pytest.mark.slow
def test_signed_sos_mle_training_decreases_nll():
    """Maximum-likelihood training of a squared non-monotonic circuit under
    the signed semiring: minimize -log(|c(x)|^2 / Z) — fully differentiable
    through the signed ops (sign components carry zero gradients)."""
    import optax

    sc = _nonmonotonic_pc()
    ctx = PipelineContext(semiring="signed-lse-sum", fold=True)
    cc = ctx.compile(sc)
    sq = ctx.multiply(ctx.conjugate(cc), cc)
    zc = ctx.integrate(sq)

    # data concentrated on one world: training must raise its likelihood.
    # Train only the (sign-unconstrained) sum weight; the raw categorical
    # probs stay frozen (training them unconstrained would need a softmax
    # reparameterization, which is orthogonal to what this test pins).
    data = jnp.asarray(np.array([[1, 2]] * 32 + [[0, 0]] * 8))
    store = dict(ctx.parameters)
    weight_slots = {
        k for k in cc.learnable_slots if store[k].shape[1:] == (1, 2)
    }
    assert weight_slots, sorted(cc.learnable_slots)
    tr = {k: v for k, v in store.items() if k in weight_slots}
    fr = {k: v for k, v in store.items() if k not in tr}
    opt = optax.adam(5e-2)
    opt_state = opt.init(tr)

    @jax.jit
    def step(tr, opt_state):
        def loss(tr):
            st = {**tr, **fr}
            ll, _ = sq.evaluate(st, data)
            za, _ = zc.evaluate(st, data[:1])
            return -jnp.mean(ll) + za[0, 0, 0]

        l, g = jax.value_and_grad(loss)(tr)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(tr, updates), opt_state, l

    losses = []
    for _ in range(40):
        tr, opt_state, l = step(tr, opt_state)
        losses.append(float(l))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])

    # the trained model must stay normalized and raise the likelihood of
    # the frequent world relative to initialization
    worlds = enumerate_worlds(2, 3)

    def world_probs(st):
        ll, _ = sq.evaluate(st, worlds)
        za, _ = zc.evaluate(st, worlds[:1])
        return np.exp(np.asarray(ll)[:, 0, 0] - float(za[0, 0, 0]))

    probs0 = world_probs(store)
    probs1 = world_probs({**tr, **fr})
    np.testing.assert_allclose(probs1.sum(), 1.0, rtol=1e-6)
    assert probs1[1 * 3 + 2] > probs0[1 * 3 + 2]
