"""Fusion-target layers: Tucker, CP-transposed and TensorDot.

Rebuild of ``cirkit/backend/torch/layers/optimized.py:13-300``: the layers
the optimizer rewrites into. Tucker contracts the arity inputs against the
core weight in one semiring einsum (never materializing the Kronecker
product); CP-T Hadamard-reduces then matmuls; TensorDot applies the
Monarch-style two-sided contraction that shatters a Kronecker-parameterized
dense sum from O(K^2) to O(K sqrt(K)) work (Zhang et al. 2025).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import jax
import jax.numpy as jnp

from cirkit_tpu.backend.jax.layers import JaxInnerLayer, softmax_logits_slot, tmap
from cirkit_tpu.backend.jax.parameters import JaxParameter, Store


class JaxTuckerLayer(JaxInnerLayer):
    """Fused sum-of-Kronecker: a multi-operand semiring einsum with the core
    weight reshaped to (F, Ko, Ki, ..., Ki)."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        arity: int = 2,
        *,
        weight: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        if arity < 2:
            raise ValueError("The arity should be at least 2")
        super().__init__(
            num_input_units, num_output_units, arity=arity, num_folds=num_folds, semiring=semiring
        )
        assert weight.shape == (num_output_units, num_input_units**arity)
        self.weight = weight
        self._logits_slot = softmax_logits_slot(weight)
        # int-axis einsum spec: inputs (f, b, k_h) each, weight (f, o, k_1..k_H)
        self._einsum = (
            tuple((0, 1, i + 2) for i in range(arity))
            + ((0, arity + 2, *(i + 2 for i in range(arity))),)
            + ((0, 1, arity + 2),)
        )

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_input_units": self.num_input_units,
            "num_output_units": self.num_output_units,
            "arity": self.arity,
        }

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        return {"weight": self.weight}

    def forward(self, store: Store, x) -> jnp.ndarray:
        if self.arity == 2:
            # The hot configuration: the arity-2 Tucker contraction, with a
            # softmax reparameterization normalized inside the op.
            x1 = tmap(lambda a: a[:, 0], x)
            x2 = tmap(lambda a: a[:, 1], x)
            if self._logits_slot is not None:
                return self.semiring.tucker2_softmax(x1, x2, store[self._logits_slot])
            return self.semiring.tucker2(x1, x2, self.weight(store))
        w = self.weight(store)  # (F, Ko, Ki^arity)
        w = w.reshape(-1, self.num_output_units, *(self.num_input_units,) * self.arity)
        inputs = tuple(tmap(lambda a, hh=h: a[:, hh], x) for h in range(self.arity))
        return self.semiring.einsum(
            self._einsum, inputs=inputs, operands=(w,), dim=-1, keepdim=True
        )

    def sample(self, store: Store, key, x):
        # Each output unit mixes over the Ki^arity composite input index:
        # draw one composite index per (fold, unit, sample), unravel it
        # row-major (matching the Kronecker flatten) and add the chosen
        # child assignments (disjoint scopes). An extension: the reference's
        # Tucker layer does not support sampling.
        w = self.weight(store)  # (F, Ko, Ki^arity), requires normalized rows
        f, h, k, n, d = x.shape
        o = w.shape[1]
        logits = jnp.log(w)
        mix = jax.random.categorical(
            key, jnp.broadcast_to(logits[:, :, None, :], (f, o, n, w.shape[2])), axis=-1
        )  # (F, O, N) composite indices
        fold_idx = jnp.arange(f)[:, None, None]
        n_idx = jnp.arange(n)[None, None, :]
        out = jnp.zeros((f, o, n, d), dtype=x.dtype)
        rem = mix
        for hh in range(h - 1, -1, -1):
            idx = rem % k
            rem = rem // k
            out = out + x[:, hh][fold_idx, idx, n_idx]
        return out, mix


class JaxCPTLayer(JaxInnerLayer):
    """Fused sum-of-Hadamard (CP-transposed): semiring product over the arity
    axis followed by a dense contraction with a (F, Ko, Ki) weight."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        arity: int = 2,
        *,
        weight: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(
            num_input_units, num_output_units, arity=arity, num_folds=num_folds, semiring=semiring
        )
        assert weight.shape == (num_output_units, num_input_units)
        self.weight = weight
        self._logits_slot = softmax_logits_slot(weight)

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_input_units": self.num_input_units,
            "num_output_units": self.num_output_units,
            "arity": self.arity,
        }

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        return {"weight": self.weight}

    def forward(self, store: Store, x) -> jnp.ndarray:
        x = self.semiring.prod(x, dim=1)  # (F, B, Ki)
        if self._logits_slot is not None:
            return self.semiring.matmul_softmax(x, store[self._logits_slot])
        return self.semiring.matmul(x, self.weight(store))

    def sample(self, store: Store, key, x):
        # identical routing to a sum layer over the Hadamard-combined inputs
        w = self.weight(store)  # (F, Ko, Ki)
        x = x.sum(axis=1)  # (F, Ki, N, D): combine disjoint assignments
        f, k, n, d = x.shape
        logits = jnp.log(w)
        mix = jax.random.categorical(
            key,
            jnp.broadcast_to(logits[:, :, None, :], (f, w.shape[1], n, w.shape[2])),
            axis=-1,
        )  # (F, Ko, N)
        fold_idx = jnp.arange(f)[:, None, None]
        n_idx = jnp.arange(n)[None, None, :]
        return x[fold_idx, mix, n_idx], mix


class JaxTensorDotLayer(JaxInnerLayer):
    """One side of the Monarch-style contraction: reshape (B, Ki) into
    (B, Kj, Kq) and contract Kj against a (F, Kk, Kj) weight, flattening
    (Kq, Kk) back into the unit axis (ref: ``layers/optimized.py:205-300``)."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        *,
        weight: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(
            num_input_units, num_output_units, arity=1, num_folds=num_folds, semiring=semiring
        )
        kk, kj = weight.shape
        if num_input_units % kj or num_output_units != kk * (num_input_units // kj):
            raise ValueError(
                f"Invalid TensorDot weight shape {weight.shape} for "
                f"Ki={num_input_units}, Ko={num_output_units}"
            )
        self.weight = weight
        self._num_contract_units = kj
        self._num_batch_units = num_input_units // kj

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_input_units": self.num_input_units,
            "num_output_units": self.num_output_units,
        }

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        return {"weight": self.weight}

    def forward(self, store: Store, x) -> jnp.ndarray:
        kq = self._num_batch_units

        def fold_in(a):
            a = a[:, 0]  # (F, B, Ki)
            f, b, _ = a.shape
            a = a.reshape(f, b, self._num_contract_units, kq)
            a = jnp.transpose(a, (0, 1, 3, 2))  # (F, B, Kq, Kj)
            return a.reshape(f, b * kq, -1)

        b = x.shape[2] if isinstance(x, jnp.ndarray) else x[0].shape[2]
        # Fold the Kq axis into the batch so the contraction hits the fused
        # semiring matmul path: (F, B*Kq, Kj) x (F, Kk, Kj) -> (F, B*Kq, Kk).
        y = self.semiring.matmul(tmap(fold_in, x), self.weight(store))
        return tmap(lambda a: a.reshape(a.shape[0], b, self.num_output_units), y)
