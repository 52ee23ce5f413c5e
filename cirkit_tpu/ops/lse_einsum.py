"""Log-einsum-exp contractions for the circuit hot path.

The log-space (lse-sum) semiring evaluates every sum layer as a max-shifted
log-einsum-exp (ref: ``cirkit/backend/torch/semiring.py:383-408``): shift by
the per-row max, exponentiate, contract in linear space, log, add the shift
back. The four public ops are that composition in plain ``jax.numpy``, left
to XLA, which hands the contraction to cuBLAS or its own GEMM kernels:

- :func:`lse_matmul` / :func:`lse_matmul_softmax` — the dense folded
  sum-layer contraction ``(F, B, I) x (F, O, I) -> (F, B, O)``;
- :func:`lse_tucker2` / :func:`lse_tucker2_softmax` — the arity-2 Tucker
  contraction ``(F, B, K1) x (F, B, K2) x (F, O, K1*K2) -> (F, B, O)``.

The ``_softmax`` variants take raw logits and normalize the weight rows
first. The log of the contraction is a safe log: division-by-zero
gradients (rows that are entirely ``-inf``) are zeroed like the
reference's ``SafeLog`` (ref: ``backend/torch/utils.py:10-30``).

The contractions take JAX's default dot precision
(``jax.default_matmul_precision``; unset, ``Precision.DEFAULT``, which is
TF32 on an H100). On the flagship that keeps the per-sample
log-likelihood within 5e-6 relative of a float64 evaluation (PERF.md,
"Precision").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _clamp_max(x: jnp.ndarray) -> jnp.ndarray:
    """Trailing-axis max clamped to finite range (ref: semiring.py:392-398),
    so rows that are entirely -inf never produce NaNs via inf - inf."""
    info = jnp.finfo(x.dtype)
    m = jnp.max(x, axis=-1, keepdims=True)
    return jnp.clip(m, info.min, info.max)


def _safelog(y: jnp.ndarray) -> jnp.ndarray:
    # imported here: the backend package imports this module
    from cirkit_tpu.backend.jax.utils import safelog

    return safelog(y)


def _as_f32(theta: jnp.ndarray) -> jnp.ndarray:
    """bf16-resident logits are normalized in f32."""
    return theta.astype(jnp.float32) if theta.dtype == jnp.bfloat16 else theta


def lse_matmul(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """``log(exp(x - max) @ w^T) + max`` over the trailing axis.

    ``x``: (F, B, I) log-space values; ``w``: (F, O, I) linear-space weights.
    Returns (F, B, O) log-space values. Equivalent to the reference sum-layer
    einsum ``"fbi,foi->fbo"`` under the lse-sum semiring.
    """
    assert x.shape[::2] == (w.shape[0], w.shape[2]), (x.shape, w.shape)
    m = _clamp_max(x)
    y = jnp.einsum("fbi,foi->fbo", jnp.exp(x - m), w)
    return _safelog(y) + m


def lse_matmul_softmax(x: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    """:func:`lse_matmul` with ``w = softmax(theta, axis=-1)``."""
    assert x.shape[::2] == (theta.shape[0], theta.shape[2]), (x.shape, theta.shape)
    return lse_matmul(x, jax.nn.softmax(_as_f32(theta), axis=-1))


def lse_tucker2(x1: jnp.ndarray, x2: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Arity-2 Tucker contraction under the lse-sum semiring.

    ``x1``: (F, B, K1) and ``x2``: (F, B, K2) log-space inputs; ``w``:
    (F, O, K1*K2) linear-space core weight, flattened row-major over (K1, K2).
    Returns (F, B, O) log-space. Equivalent to Kronecker-then-sum (ref:
    ``layers/optimized.py:13-104``).
    """
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    assert x2.shape[:2] == (f, b) and w.shape[::2] == (f, k1 * k2), (
        x1.shape,
        x2.shape,
        w.shape,
    )
    m1 = _clamp_max(x1)
    m2 = _clamp_max(x2)
    w3 = w.reshape(w.shape[0], w.shape[1], k1, k2)
    y = jnp.einsum("fbi,fbj,foij->fbo", jnp.exp(x1 - m1), jnp.exp(x2 - m2), w3)
    return _safelog(y) + m1 + m2


def lse_tucker2_softmax(
    x1: jnp.ndarray, x2: jnp.ndarray, theta: jnp.ndarray
) -> jnp.ndarray:
    """:func:`lse_tucker2` with ``w = softmax(theta, axis=-1)``."""
    return lse_tucker2(x1, x2, jax.nn.softmax(_as_f32(theta), axis=-1))
