"""The log-einsum-exp contractions (``ops/lse_einsum.py``) and the signed and
complex semiring contractions, against float64/complex128 numpy references.

Mirrors the reference's semiring numerics coverage
(``tests/backend/torch/test_semiring.py``) extended with gradient checks,
the safe-log gradient rule on all-``-inf`` rows, bf16 weight stores and the
dot-precision rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cirkit_tpu.ops import lse_einsum as L

# f32 inputs against a float64 reference: f32 rounding of exp/log and the
# contraction sums stays far below these
ATOL = 1e-5
RTOL = 1e-5

OPS = ["matmul", "matmul_softmax", "tucker2", "tucker2_softmax"]


def _rand(rng, shape, scale=3.0, shift=-2.0, dtype=jnp.float32):
    return jnp.asarray(rng.normal(size=shape) * scale + shift, dtype)


def _weights(rng, shape, dtype=jnp.float32):
    return jnp.asarray(rng.uniform(0.01, 1.0, size=shape), dtype)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16 else a, np.float64)


def _np_softmax(theta):
    t = _np(theta)
    e = np.exp(t - t.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _np_matmul(x, w):
    x, w = _np(x), _np(w)
    m = np.clip(x.max(-1, keepdims=True), np.finfo(np.float64).min, None)
    with np.errstate(divide="ignore"):
        return np.log(np.einsum("fbi,foi->fbo", np.exp(x - m), w)) + m


def _np_tucker(x1, x2, w):
    x1, x2, w = _np(x1), _np(x2), _np(w)
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    x12 = (x1[:, :, :, None] + x2[:, :, None, :]).reshape(f, b, k1 * k2)
    return _np_matmul(x12, w)


def _case(op, rng, f, b, k, o, dtype=jnp.float32, wdtype=None):
    """(jax fn of the log-space inputs, inputs, float64 numpy reference)."""
    wdtype = dtype if wdtype is None else wdtype
    soft = op.endswith("softmax")
    if op.startswith("matmul"):
        xs = (_rand(rng, (f, b, k), dtype=dtype),)
    else:
        xs = (_rand(rng, (f, b, k), dtype=dtype), _rand(rng, (f, b, k + 1), dtype=dtype))
    width = k if op.startswith("matmul") else k * (k + 1)
    w = (
        _rand(rng, (f, o, width), scale=1.0, shift=0.0, dtype=wdtype)
        if soft
        else _weights(rng, (f, o, width), dtype=wdtype)
    )
    fn = {
        "matmul": L.lse_matmul,
        "matmul_softmax": L.lse_matmul_softmax,
        "tucker2": L.lse_tucker2,
        "tucker2_softmax": L.lse_tucker2_softmax,
    }[op]
    wref = _np_softmax(w) if soft else _np(w)
    ref = _np_matmul(xs[0], wref) if len(xs) == 1 else _np_tucker(*xs, wref)
    return fn, xs, w, ref


# --------------------------------------------------------------------------- #
# The public ops
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("b", [8, 13])
def test_lse_matmul_matches_fallback(b):
    rng = np.random.default_rng(0)
    x = _rand(rng, (3, b, 32))
    w = _weights(rng, (3, 16, 32))
    np.testing.assert_allclose(L.lse_matmul(x, w), _np_matmul(x, w), rtol=RTOL, atol=ATOL)


def test_lse_matmul_softmax_matches_composition():
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 8, 32))
    theta = _rand(rng, (2, 16, 32), scale=1.0, shift=0.0)
    np.testing.assert_allclose(
        L.lse_matmul_softmax(x, theta), _np_matmul(x, _np_softmax(theta)), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("b", [8, 11])
def test_lse_tucker2_matches_fallback(b):
    rng = np.random.default_rng(2)
    x1 = _rand(rng, (3, b, 8))
    x2 = _rand(rng, (3, b, 16))
    w = _weights(rng, (3, 8, 8 * 16))
    np.testing.assert_allclose(L.lse_tucker2(x1, x2, w), _np_tucker(x1, x2, w), rtol=RTOL, atol=ATOL)


def test_lse_tucker2_softmax_matches_composition():
    rng = np.random.default_rng(3)
    x1 = _rand(rng, (2, 8, 8))
    x2 = _rand(rng, (2, 8, 8))
    theta = _rand(rng, (2, 8, 64), scale=1.0, shift=0.0)
    np.testing.assert_allclose(
        L.lse_tucker2_softmax(x1, x2, theta),
        _np_tucker(x1, x2, _np_softmax(theta)),
        rtol=RTOL,
        atol=ATOL,
    )


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize(
    "shape", [(3, 5, 7, 6), (2, 1, 8, 4), (1, 16, 33, 9)], ids=["odd-k", "batch-1", "k33"]
)
def test_ops_match_f64_over_shape_grid(op, shape):
    """Odd widths, a batch of one and a width past a power of two."""
    fn, xs, w, ref = _case(op, np.random.default_rng(40), *shape)
    out = fn(*xs, w)
    assert out.shape == ref.shape and out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out, np.float64), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", OPS)
def test_ops_keep_float64(op):
    """float64 inputs stay float64 end to end (the parity tests' path)."""
    fn, xs, w, ref = _case(op, np.random.default_rng(41), 2, 4, 6, 5, dtype=jnp.float64)
    out = fn(*xs, w)
    assert out.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op", OPS)
def test_ops_accept_bf16_weights(op):
    """A bf16-resident weight store: the contraction runs in f32 on the
    bf16 values (softmax logits are normalized in f32)."""
    fn, xs, w, ref = _case(op, np.random.default_rng(42), 2, 6, 8, 5, wdtype=jnp.bfloat16)
    assert w.dtype == jnp.bfloat16
    out = fn(*xs, w)
    assert out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out, np.float64), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", OPS)
def test_gradients_match_f64(op):
    """Gradients of the f32 ops against autodiff of the same ops in f64."""
    fn, xs, w, _ = _case(op, np.random.default_rng(43), 2, 4, 6, 5)
    loss = lambda *a: jnp.sum(jnp.sin(fn(*a)))
    args = (*xs, w)
    g32 = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    g64 = jax.grad(loss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a, jnp.float64) for a in args)
    )
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op", OPS)
def test_safelog_gradient_on_neg_inf_rows(op):
    """A row that is entirely -inf (zero probability) gives -inf out and a
    zero, NaN-free gradient, like the reference's SafeLog."""
    fn, xs, w, _ = _case(op, np.random.default_rng(44), 2, 6, 8, 5)
    xs = (xs[0].at[1, 3].set(-jnp.inf),) + xs[1:]
    out = fn(*xs, w)
    assert bool(jnp.all(jnp.isneginf(out[1, 3])))
    assert bool(jnp.all(jnp.isfinite(out[0]))) and bool(jnp.all(jnp.isfinite(out[1, :3])))

    def loss(*a):
        y = fn(*a)
        return jnp.sum(jnp.where(jnp.isfinite(y), y, 0.0))

    grads = jax.grad(loss, argnums=tuple(range(len(xs) + 1)))(*xs, w)
    for g in grads:
        assert not bool(jnp.any(jnp.isnan(g)))
    assert bool(jnp.all(grads[0][1, 3] == 0.0))


@pytest.mark.parametrize(
    "name,want",
    [
        ("lse-sum", None),
        ("sum-product", None),
        ("signed-lse-sum", jax.lax.Precision.HIGHEST),
        ("complex-lse-sum", jax.lax.Precision.HIGHEST),
    ],
)
def test_semiring_dot_precision_rule(name, want):
    """Monotone semirings take JAX's default dot precision; the cancelling
    ones ask for HIGHEST; JAX's own setting wins over both."""
    from cirkit_tpu.backend.jax.semiring import SemiringImpl

    sr = SemiringImpl.from_name(name)
    assert sr.dot_precision() == want
    with jax.default_matmul_precision("default"):
        assert sr.dot_precision() is None


# --------------------------------------------------------------------------- #
# Wide Tucker widths (K >= 128)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize(
    "shape", [(2, 16, 128, 128, 64), (1, 13, 128, 64, 16), (1, 8, 256, 128, 32)]
)
def test_chunked_tucker_matches_f64(shape, softmax):
    """K >= 128 Tucker widths against a float64 oracle — 1e-4 nats."""
    f, b, k1, k2, o = shape
    rng = np.random.default_rng(7)
    x1 = _rand(rng, (f, b, k1))
    x2 = _rand(rng, (f, b, k2))
    if softmax:
        w = _rand(rng, (f, o, k1 * k2), scale=2.0, shift=0.0)
        got = L.lse_tucker2_softmax(x1, x2, w)
        want = _np_tucker(x1, x2, _np_softmax(w))
    else:
        w = _weights(rng, (f, o, k1 * k2))
        got = L.lse_tucker2(x1, x2, w)
        want = _np_tucker(x1, x2, w)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=1e-4)


def test_chunked_tucker_all_neg_inf_row_yields_no_nan():
    """Rows that are entirely log-zero stay NaN-free at K=128 (the clamped
    shift)."""
    rng = np.random.default_rng(5)
    x1 = _rand(rng, (1, 8, 128))
    x2 = _rand(rng, (1, 8, 128))
    x1 = x1.at[0, 3].set(-jnp.inf)
    w = _weights(rng, (1, 16, 128 * 128))
    out = np.asarray(L.lse_tucker2(x1, x2, w))
    assert not np.isnan(out).any()
    assert np.all(out[0, 3] == -np.inf)


# --------------------------------------------------------------------------- #
# Complex semiring (squared circuits): complex128 reference
# --------------------------------------------------------------------------- #


def _crand(rng, shape, scale=1.5):
    re = rng.normal(size=shape) * scale - 1.0
    im = rng.normal(size=shape) * scale
    return jnp.asarray(re + 1j * im, jnp.complex64)


def test_complex_semiring_tucker2_kernel_matches_fallback():
    """The complex Tucker contraction against a complex128 oracle."""
    from cirkit_tpu.backend.jax.semiring import ComplexLSESumSemiring as C

    rng = np.random.default_rng(23)
    x1 = _crand(rng, (2, 8, 8))
    x2 = _crand(rng, (2, 8, 8))
    w = _crand(rng, (2, 16, 64))
    got = np.asarray(C.tucker2(x1, x2, w))
    a1, a2 = np.asarray(x1, np.complex128), np.asarray(x2, np.complex128)
    m1 = a1.real.max(-1, keepdims=True)
    m2 = a2.real.max(-1, keepdims=True)
    w3 = np.asarray(w, np.complex128).reshape(2, 16, 8, 8)
    y = np.einsum("fbi,fbj,foij->fbo", np.exp(a1 - m1), np.exp(a2 - m2), w3)
    want = np.log(y) + m1 + m2
    np.testing.assert_allclose(got.real, want.real, rtol=1e-4, atol=1e-4)
    dphi = np.angle(np.exp(1j * (got.imag - want.imag)))
    np.testing.assert_allclose(dphi, 0.0, atol=1e-4)


# --------------------------------------------------------------------------- #
# Signed semiring (the all-real SoS path): float64 reference
# --------------------------------------------------------------------------- #


def _signs(rng, shape):
    return jnp.asarray(rng.choice([-1.0, 1.0], size=shape), jnp.float32)


def _np_signed_matmul(a, s, w):
    a, s, w = _np(a), _np(s), _np(w)
    m = a.max(-1, keepdims=True)
    y = np.einsum("fbi,foi->fbo", s * np.exp(a - m), w)
    return np.log(np.abs(y)) + m, np.sign(y)


@pytest.mark.parametrize("b", [8, 13])
def test_slse_matmul_matches_fallback(b):
    from cirkit_tpu.backend.jax.semiring import SignedLSESemiring as S

    rng = np.random.default_rng(30)
    a = _rand(rng, (3, b, 32))
    s = _signs(rng, (3, b, 32))
    w = _weights(rng, (3, 16, 32))
    oa, os_ = S.matmul((a, s), w)
    ra, rs = _np_signed_matmul(a, s, w)
    np.testing.assert_allclose(np.asarray(oa, np.float64), ra, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(os_), rs)


def test_slse_tucker2_softmax_matches_fallback():
    from cirkit_tpu.backend.jax.semiring import SignedLSESemiring as S

    rng = np.random.default_rng(31)
    a1, s1 = _rand(rng, (2, 8, 8)), _signs(rng, (2, 8, 8))
    a2, s2 = _rand(rng, (2, 8, 8)), _signs(rng, (2, 8, 8))
    th = _rand(rng, (2, 8, 64), scale=1.0, shift=0.0)
    oa, os_ = S.tucker2_softmax((a1, s1), (a2, s2), th)
    f, b, k = a1.shape
    a12 = (_np(a1)[:, :, :, None] + _np(a2)[:, :, None, :]).reshape(f, b, k * k)
    s12 = (_np(s1)[:, :, :, None] * _np(s2)[:, :, None, :]).reshape(f, b, k * k)
    ra, rs = _np_signed_matmul(a12, s12, _np_softmax(th))
    np.testing.assert_allclose(np.asarray(oa, np.float64), ra, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(os_), rs)


def _signed_ref64(a, s, w):
    """The signed contraction in float64 ``jax.numpy``, written out from its
    definition: log|y| and sign(y) of ``y = (s * exp(a)) @ w^T``."""
    y = jnp.einsum("fbi,foi->fbo", s * jnp.exp(a), w)
    return jnp.log(jnp.abs(y)), jnp.sign(y)


@pytest.mark.parametrize("softmax", [False, True])
def test_slse_bf16_weight_gradients(softmax):
    """Gradients through a bf16-resident weight store on the signed
    contraction: dL/dw comes back in bf16 and agrees with float64 autodiff
    of the written-out contraction."""
    from cirkit_tpu.backend.jax.semiring import SignedLSESemiring as S

    rng = np.random.default_rng(34)
    a = _rand(rng, (2, 8, 32))
    s = _signs(rng, (2, 8, 32))
    if softmax:
        w32 = _rand(rng, (2, 16, 32), scale=1.0, shift=0.0)
    else:
        w32 = _weights(rng, (2, 16, 32))
    w16 = w32.astype(jnp.bfloat16)

    def loss(a, w):
        oa, os_ = (S.matmul_softmax if softmax else S.matmul)((a, s), w)
        return jnp.sum(jnp.sin(oa) * os_)

    def loss_ref(a, w):
        w = jax.nn.softmax(w, axis=-1) if softmax else w
        oa, os_ = _signed_ref64(a, jnp.asarray(s, jnp.float64), w)
        return jnp.sum(jnp.sin(oa) * os_)

    ga, gw = jax.grad(loss, argnums=(0, 1))(a, w16)
    ga_ref, gw_ref = jax.grad(loss_ref, argnums=(0, 1))(
        jnp.asarray(a, jnp.float64), jnp.asarray(w16.astype(jnp.float32), jnp.float64)
    )
    assert gw.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(ga, np.float64), np.asarray(ga_ref), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(
        np.asarray(gw.astype(jnp.float32), np.float64), np.asarray(gw_ref), rtol=5e-2, atol=5e-2
    )


def test_slse_exact_cancellation_sign_zero_no_nan():
    """Exact cancellation to 0 gives sign 0, log -inf, and finite (zero)
    gradients: the signed analogue of ComplexSafeLog."""
    from cirkit_tpu.backend.jax.semiring import SignedLSESemiring as S

    a = jnp.zeros((1, 8, 16), jnp.float32)
    s = jnp.asarray(np.tile([1.0, -1.0], 8), jnp.float32)[None, None, :].repeat(8, 1)
    w = jnp.ones((1, 8, 16), jnp.float32)
    oa, os_ = S.matmul((a, s), w)
    assert bool(jnp.all(os_ == 0.0))
    assert bool(jnp.all(jnp.isneginf(oa)))

    def loss(a, w):
        out = S.matmul((a, s), w)[0]
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    ga, gw = jax.grad(loss, argnums=(0, 1))(a, w)
    assert not bool(jnp.any(jnp.isnan(ga))) and not bool(jnp.any(jnp.isnan(gw)))
    assert bool(jnp.all(ga == 0.0)) and bool(jnp.all(gw == 0.0))


def test_clse_matmul_gradients_match_fallback():
    """Gradients of the complex contraction against complex128 autodiff of
    the written-out ``log(exp(x) @ w^T)``."""
    from cirkit_tpu.backend.jax.semiring import ComplexLSESumSemiring as C

    rng = np.random.default_rng(22)
    x = _crand(rng, (2, 8, 32))
    w = _crand(rng, (2, 16, 32))

    def head(out):
        return jnp.sum(jnp.sin(out.real) + 0.7 * jnp.cos(out.imag))

    def loss_ref(x, w):
        return head(jnp.log(jnp.einsum("fbi,foi->fbo", jnp.exp(x), w)))

    got = jax.grad(lambda x, w: head(C.matmul(x, w)), argnums=(0, 1))(x, w)
    want = jax.grad(loss_ref, argnums=(0, 1))(
        jnp.asarray(x, jnp.complex128), jnp.asarray(w, jnp.complex128)
    )
    for g, r in zip(got, want):
        assert g.dtype == jnp.complex64
        np.testing.assert_allclose(np.asarray(g, np.complex128), np.asarray(r), rtol=5e-3, atol=5e-3)
