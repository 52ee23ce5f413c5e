"""Pluggable evaluation semirings.

Rebuild of ``cirkit/backend/torch/semiring.py:19-514``: a (⊕, ⊗) algebra the
compiled plan evaluates under, with a string registry and cross-semiring
morphisms. The log-space semirings implement the numerically-stable
max-shift log-einsum-exp: shift each semiring operand by its clamped max
along the contracted axis, exponentiate, run the einsum in linear space,
then take the log and add the shifts back. The lse-sum dense and Tucker
contractions live in ``cirkit_tpu/ops/lse_einsum.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Iterable, Sequence
from functools import reduce
from typing import ClassVar, Protocol

import jax
import jax.numpy as jnp

from cirkit_tpu.backend.jax.utils import (
    csafelog,
    default_real_dtype,
    safelog,
    to_complex_dtype,
)
from cirkit_tpu.ops.lse_einsum import (
    _as_f32,
    lse_matmul,
    lse_matmul_softmax,
    lse_tucker2,
    lse_tucker2_softmax,
)

Semiring = type["SemiringImpl"]


class EinsumFunc(Protocol):
    def __call__(self, *xs: jnp.ndarray) -> jnp.ndarray: ...


def _finfo_clamp(x: jnp.ndarray) -> jnp.ndarray:
    info = jnp.finfo(x.dtype)
    return jnp.clip(x, info.min, info.max)


class SemiringImpl(ABC):
    """Base class for semiring implementations over jnp arrays."""

    _registry: ClassVar[dict[str, Semiring]] = {}
    _morphisms: ClassVar[dict[tuple[Semiring, Semiring], Callable]] = {}
    # Dot precision of the contractions; None takes JAX's default
    # (Precision.DEFAULT: TF32 on an H100). Semirings whose sums cancel
    # (signed, complex) need more: TF32 made their squared circuits' log
    # values up to 3e-3 relative off a float64 evaluation on an H100,
    # HIGHEST 2e-4 (PERF.md, "Precision").
    precision: ClassVar[jax.lax.Precision | None] = None

    def __new__(cls) -> "SemiringImpl":
        raise TypeError("Semirings are static namespaces and cannot be instantiated")

    # -- registry -------------------------------------------------------------
    @staticmethod
    def register(name: str) -> Callable[[Semiring], Semiring]:
        def _decorator(cls: Semiring) -> Semiring:
            SemiringImpl._registry[name] = cls
            return cls

        return _decorator

    @classmethod
    def register_map_from(cls, other: Semiring) -> Callable[[Callable], Callable]:
        def _decorator(func: Callable) -> Callable:
            SemiringImpl._morphisms[(other, cls)] = func
            return func

        return _decorator

    @classmethod
    def dot_precision(cls) -> jax.lax.Precision | None:
        """The semiring's :attr:`precision`, unless JAX's own default
        (``jax.default_matmul_precision``) is set, which then wins."""
        if jax.config.jax_default_matmul_precision is not None:
            return None
        return cls.precision

    @staticmethod
    def list() -> Iterable[str]:
        return iter(SemiringImpl._registry)

    @staticmethod
    def from_name(name: str) -> Semiring:
        if name not in SemiringImpl._registry:
            raise IndexError(
                f"Unknown semiring '{name}'; register one with "
                f"@SemiringImpl.register('{name}')"
            )
        return SemiringImpl._registry[name]

    @classmethod
    def map_from(cls, x: jnp.ndarray, semiring: Semiring) -> jnp.ndarray:
        """Map values represented in another semiring into this one."""
        if cls is semiring:
            return x
        func = SemiringImpl._morphisms.get((semiring, cls))
        if func is None:
            raise NotImplementedError(
                f"No morphism from '{semiring.__name__}' to '{cls.__name__}'"
            )
        return func(x)

    # -- generic einsum -------------------------------------------------------
    @classmethod
    def einsum(
        cls,
        equation: str | Sequence[Sequence[int]],
        *,
        inputs: tuple[jnp.ndarray, ...] | None = None,
        operands: tuple[jnp.ndarray, ...] | None = None,
        dim: int,
        keepdim: bool,
    ) -> jnp.ndarray:
        """An einsum whose additions/multiplications follow this semiring.

        ``inputs`` are semiring-represented values (e.g. log-space); the extra
        ``operands`` (e.g. sum-layer weights) are linear-space and only cast.
        ``dim`` is the axis of the inputs that is contracted (used for the
        max-shift); ``keepdim`` keeps that axis as size 1 in the output.
        """
        inputs = () if inputs is None else inputs
        operands = () if operands is None else operands

        if isinstance(equation, str):

            def func(*xs: jnp.ndarray) -> jnp.ndarray:
                return jnp.einsum(
                    equation,
                    *xs,
                    *(cls.cast(o) for o in operands),
                    precision=cls.dot_precision(),
                )

        else:

            def func(*xs: jnp.ndarray) -> jnp.ndarray:
                args: list = []
                all_ops = xs + tuple(cls.cast(o) for o in operands)
                for op, spec in zip(all_ops, equation[:-1]):
                    args.extend((op, list(spec)))
                args.append(list(equation[-1]))
                return jnp.einsum(*args, precision=cls.dot_precision())

        return cls.apply_reduce(func, *inputs, dim=dim, keepdim=keepdim)

    # -- the sum-layer contractions ---------------------------------------------
    @classmethod
    def matmul(cls, x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
        """The dense sum-layer contraction: semiring values ``x`` (F, B, I)
        against linear-space weights ``w`` (F, O, I) -> (F, B, O)."""
        return cls.einsum("fbi,foi->fbo", inputs=(x,), operands=(w,), dim=-1, keepdim=True)

    @classmethod
    def tucker2(
        cls, x1: jnp.ndarray, x2: jnp.ndarray, w: jnp.ndarray
    ) -> jnp.ndarray:
        """The arity-2 Tucker contraction: semiring values ``x1`` (F, B, K1)
        and ``x2`` (F, B, K2) against the linear-space core ``w``
        (F, O, K1*K2), flattened row-major -> (F, B, O)."""
        k1 = x1.shape[-1]
        k2 = x2.shape[-1]
        w3 = w.reshape(w.shape[0], w.shape[1], k1, k2)
        return cls.einsum(
            "fbi,fbj,foij->fbo", inputs=(x1, x2), operands=(w3,), dim=-1, keepdim=True
        )

    @classmethod
    def matmul_softmax(cls, x: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
        """:meth:`matmul` with weights ``softmax(theta, axis=-1)``; bf16
        logits are normalized in f32."""
        return cls.matmul(x, jax.nn.softmax(_as_f32(theta), axis=-1))

    @classmethod
    def tucker2_softmax(
        cls, x1: jnp.ndarray, x2: jnp.ndarray, theta: jnp.ndarray
    ) -> jnp.ndarray:
        """:meth:`tucker2` with core weights ``softmax(theta, axis=-1)``;
        bf16 logits are normalized in f32."""
        return cls.tucker2(x1, x2, jax.nn.softmax(_as_f32(theta), axis=-1))

    # -- abstract algebra ------------------------------------------------------
    @classmethod
    @abstractmethod
    def cast(cls, x: jnp.ndarray) -> jnp.ndarray:
        """Cast to the value dtype of this semiring."""

    @classmethod
    @abstractmethod
    def sum(cls, x: jnp.ndarray, dim: int, *, keepdim: bool = False) -> jnp.ndarray:
        """Semiring sum-reduce along an axis."""

    @classmethod
    @abstractmethod
    def add(cls, *xs: jnp.ndarray) -> jnp.ndarray:
        """Semiring addition of broadcastable arrays."""

    @classmethod
    @abstractmethod
    def prod(cls, x: jnp.ndarray, dim: int, *, keepdim: bool = False) -> jnp.ndarray:
        """Semiring product-reduce along an axis."""

    @classmethod
    @abstractmethod
    def mul(cls, *xs: jnp.ndarray) -> jnp.ndarray:
        """Semiring multiplication of broadcastable arrays."""

    @classmethod
    @abstractmethod
    def apply_reduce(
        cls, func: EinsumFunc, *xs: jnp.ndarray, dim: int, keepdim: bool
    ) -> jnp.ndarray:
        """Apply a linear-space sum-like function to semiring-space inputs."""


@SemiringImpl.register("sum-product")
class SumProductSemiring(SemiringImpl):
    """Plain linear-space evaluation."""

    @classmethod
    def cast(cls, x: jnp.ndarray) -> jnp.ndarray:
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            raise ValueError(f"Cannot cast dtype '{x.dtype}' to {cls.__name__}")
        return x.astype(default_real_dtype())

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        return x.sum(axis=dim, keepdims=keepdim)

    @classmethod
    def add(cls, *xs):
        return reduce(jnp.add, xs)

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        return x.prod(axis=dim, keepdims=keepdim)

    @classmethod
    def mul(cls, *xs):
        return reduce(jnp.multiply, xs)

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        return func(*xs)


@SemiringImpl.register("lse-sum")
class LSESumSemiring(SemiringImpl):
    """Log-space evaluation: (logsumexp, +)."""

    @classmethod
    def cast(cls, x: jnp.ndarray) -> jnp.ndarray:
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            raise ValueError(f"Cannot cast dtype '{x.dtype}' to {cls.__name__}")
        return x.astype(default_real_dtype())

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        m = _finfo_clamp(jnp.max(x, axis=dim, keepdims=True))
        out = jnp.log(jnp.sum(jnp.exp(x - m), axis=dim, keepdims=keepdim))
        return out + (m if keepdim else m.squeeze(dim))

    @classmethod
    def add(cls, *xs):
        return reduce(jnp.logaddexp, xs)

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        return x.sum(axis=dim, keepdims=keepdim)

    @classmethod
    def mul(cls, *xs):
        return reduce(jnp.add, xs)

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        # The max-shift trick (ref: semiring.py:383-408): shift by the clamped
        # max along the contracted axis so exp() never overflows, contract in
        # linear space, then log and add the shifts back.
        maxs = [_finfo_clamp(jnp.max(x, axis=dim, keepdims=True)) for x in xs]
        exps = [jnp.exp(x - m) for x, m in zip(xs, maxs)]
        out = func(*exps)
        shift = reduce(jnp.add, maxs)
        if not keepdim:
            shift = shift.squeeze(dim)
        return jnp.log(out) + shift

    @classmethod
    def matmul(cls, x, w):
        return lse_matmul(x, cls.cast(w))

    @classmethod
    def tucker2(cls, x1, x2, w):
        return lse_tucker2(x1, x2, cls.cast(w))

    @classmethod
    def matmul_softmax(cls, x, theta):
        return lse_matmul_softmax(x, cls.cast(theta))

    @classmethod
    def tucker2_softmax(cls, x1, x2, theta):
        return lse_tucker2_softmax(x1, x2, cls.cast(theta))


@SemiringImpl.register("complex-lse-sum")
class ComplexLSESumSemiring(SemiringImpl):
    """Complex log-space evaluation (for squared / SoS circuits)."""

    precision = jax.lax.Precision.HIGHEST

    @classmethod
    def cast(cls, x: jnp.ndarray) -> jnp.ndarray:
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            return x
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(to_complex_dtype(x.dtype))
        return x.astype(to_complex_dtype(default_real_dtype()))

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        m = _finfo_clamp(jnp.max(x.real, axis=dim, keepdims=True))
        out = csafelog(jnp.sum(jnp.exp(x - m), axis=dim, keepdims=keepdim))
        return out + (m if keepdim else m.squeeze(dim))

    @classmethod
    def add(cls, *xs):
        def _logaddexp(a, b):
            m = _finfo_clamp(jnp.maximum(a.real, b.real))
            return csafelog(jnp.exp(a - m) + jnp.exp(b - m)) + m

        return reduce(_logaddexp, (cls.cast(x) for x in xs))

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        return x.sum(axis=dim, keepdims=keepdim)

    @classmethod
    def mul(cls, *xs):
        return reduce(jnp.add, xs)

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        xs = tuple(cls.cast(x) for x in xs)
        maxs = [_finfo_clamp(jnp.max(x.real, axis=dim, keepdims=True)) for x in xs]
        exps = [jnp.exp(x - m) for x, m in zip(xs, maxs)]
        out = func(*exps)
        shift = reduce(jnp.add, maxs)
        if not keepdim:
            shift = shift.squeeze(dim)
        return csafelog(out) + shift


@SemiringImpl.register("signed-lse-sum")
class SignedLSESemiring(SemiringImpl):
    """Signed log-space evaluation: values are ``(log|f|, sign)`` pairs of
    real arrays (sign in {-1, 0, +1}).

    An all-real alternative to :class:`ComplexLSESumSemiring` for circuits
    whose *parameters* are real but whose values may go negative — squared /
    sum-of-squares circuits, differentials, polynomials (the reference
    evaluates these under its complex semiring,
    ``backend/torch/semiring.py:411-476``). When every parameter is real the
    phase of any circuit value is 0 or pi, so carrying a sign is exact, and
    the whole program stays in real f32 arithmetic. Gradients of the
    sign component are zero (it is piecewise constant); magnitudes use
    :func:`safelog` so exact cancellations to 0 produce zeroed gradients
    like the reference's ``ComplexSafeLog``.
    """

    precision = jax.lax.Precision.HIGHEST

    @classmethod
    def cast(cls, x: jnp.ndarray) -> jnp.ndarray:
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            raise ValueError(
                "The signed semiring supports only real parameters; compile "
                "complex-parameterized circuits under 'complex-lse-sum'"
            )
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x
        return x.astype(default_real_dtype())

    @staticmethod
    def _from_linear(v: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        return safelog(jnp.abs(v)), jnp.sign(v)

    @classmethod
    def sum(cls, x, dim, *, keepdim=False):
        a, s = x
        m = _finfo_clamp(jnp.max(a, axis=dim, keepdims=True))
        v = jnp.sum(s * jnp.exp(a - m), axis=dim, keepdims=keepdim)
        a_out, s_out = cls._from_linear(v)
        return a_out + (m if keepdim else m.squeeze(dim)), s_out

    @classmethod
    def add(cls, *xs):
        def _signed_logaddexp(x, y):
            (a1, s1), (a2, s2) = x, y
            m = _finfo_clamp(jnp.maximum(a1, a2))
            v = s1 * jnp.exp(a1 - m) + s2 * jnp.exp(a2 - m)
            a_out, s_out = cls._from_linear(v)
            return a_out + m, s_out

        return reduce(_signed_logaddexp, xs)

    @classmethod
    def prod(cls, x, dim, *, keepdim=False):
        a, s = x
        return a.sum(axis=dim, keepdims=keepdim), s.prod(axis=dim, keepdims=keepdim)

    @classmethod
    def mul(cls, *xs):
        return (
            reduce(jnp.add, (a for a, _ in xs)),
            reduce(jnp.multiply, (s for _, s in xs)),
        )

    @classmethod
    def apply_reduce(cls, func, *xs, dim, keepdim):
        maxs = [_finfo_clamp(jnp.max(a, axis=dim, keepdims=True)) for a, _ in xs]
        exps = [s * jnp.exp(a - m) for (a, s), m in zip(xs, maxs)]
        out = func(*exps)
        shift = reduce(jnp.add, maxs)
        if not keepdim:
            shift = shift.squeeze(dim)
        a_out, s_out = cls._from_linear(out)
        return a_out + shift, s_out

    @classmethod
    def matmul(cls, x, w):
        a, s = x
        w = cls.cast(w)
        m = _clamp_max_last(a)
        y = jnp.einsum("fbi,foi->fbo", s * jnp.exp(a - m), w, precision=cls.dot_precision())
        a_out, s_out = cls._from_linear(y)
        return a_out + m, s_out

    @classmethod
    def tucker2(cls, x1, x2, w):
        (a1, s1), (a2, s2) = x1, x2
        w = cls.cast(w)
        k1, k2 = a1.shape[-1], a2.shape[-1]
        w = w.reshape(w.shape[0], w.shape[1], k1, k2)
        m1, m2 = _clamp_max_last(a1), _clamp_max_last(a2)
        y = jnp.einsum(
            "fbi,fbj,foij->fbo",
            s1 * jnp.exp(a1 - m1),
            s2 * jnp.exp(a2 - m2),
            w,
            precision=cls.dot_precision(),
        )
        a_out, s_out = cls._from_linear(y)
        return a_out + m1 + m2, s_out


def _clamp_max_last(x: jnp.ndarray) -> jnp.ndarray:
    info = jnp.finfo(x.dtype)
    return jnp.clip(jnp.max(x, axis=-1, keepdims=True), info.min, info.max)


@SumProductSemiring.register_map_from(LSESumSemiring)
def _lse_to_linear(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.exp(x)


@SumProductSemiring.register_map_from(ComplexLSESumSemiring)
def _clse_to_linear(x: jnp.ndarray) -> jnp.ndarray:
    # Imaginary parts are assumed to cancel; keep the real exponential.
    return jnp.exp(x).real


@LSESumSemiring.register_map_from(SumProductSemiring)
def _linear_to_lse(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.log(x)


@LSESumSemiring.register_map_from(ComplexLSESumSemiring)
def _clse_to_lse(x: jnp.ndarray) -> jnp.ndarray:
    return x.real


@ComplexLSESumSemiring.register_map_from(SumProductSemiring)
def _linear_to_clse(x: jnp.ndarray) -> jnp.ndarray:
    return csafelog(ComplexLSESumSemiring.cast(x))


@ComplexLSESumSemiring.register_map_from(LSESumSemiring)
def _lse_to_clse(x: jnp.ndarray) -> jnp.ndarray:
    return ComplexLSESumSemiring.cast(x)


@SignedLSESemiring.register_map_from(LSESumSemiring)
def _lse_to_signed(x: jnp.ndarray):
    return x, jnp.ones_like(x)


@SignedLSESemiring.register_map_from(SumProductSemiring)
def _linear_to_signed(x: jnp.ndarray):
    return SignedLSESemiring._from_linear(SignedLSESemiring.cast(x))


@LSESumSemiring.register_map_from(SignedLSESemiring)
def _signed_to_lse(x) -> jnp.ndarray:
    # Like the complex->lse morphism (take the real part of the log), the
    # sign is assumed non-negative at the conversion point.
    return x[0]


@SumProductSemiring.register_map_from(SignedLSESemiring)
def _signed_to_linear(x) -> jnp.ndarray:
    return x[1] * jnp.exp(x[0])


@ComplexLSESumSemiring.register_map_from(SignedLSESemiring)
def _signed_to_clse(x) -> jnp.ndarray:
    a, s = x
    z = ComplexLSESumSemiring.cast(a)
    # phase 0 for non-negative values, pi for negative ones
    return z + 1j * jnp.pi * (s < 0).astype(a.dtype)


@SignedLSESemiring.register_map_from(ComplexLSESumSemiring)
def _clse_to_signed(x: jnp.ndarray):
    # valid when the phase is (numerically) 0 or pi — real-valued circuits
    return x.real, jnp.sign(jnp.cos(x.imag))
