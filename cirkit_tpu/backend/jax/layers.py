"""Compiled layers for the JAX backend.

Rebuild of ``cirkit/backend/torch/layers/`` redesigned as pure functions
over the parameter store:

- inner layers:  ``forward(store, x)`` with ``x: (F, H, B, Ki) -> (F, B, Ko)``
- input layers:  ``forward(store, x)`` with ``x: (F, B, D)  -> (F, B, K)``
- constant layers: ``forward(store, batch_size)``

F is the fold axis (homogeneous layers vectorized into one kernel launch,
the reference's main performance lever), H the arity, B the batch. All
methods are jit-traceable; parameters are read through compiled parameter
graphs so reparameterizations fuse into the layer einsum under XLA.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from collections.abc import Mapping
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.parameters import (
    JaxParameter,
    JaxSoftmaxParameter,
    JaxTensorSlot,
    Store,
)
from cirkit_tpu.backend.jax.semiring import (
    LSESumSemiring,
    Semiring,
    SumProductSemiring,
)
from cirkit_tpu.backend.jax.utils import safelog

tmap = jax.tree_util.tree_map
"""Value-space shape ops map over the semiring value's pytree leaves (a
bare array, or a (logmag, sign) pair under the signed semiring)."""


def softmax_logits_slot(param: JaxParameter) -> str | None:
    """If ``param`` is exactly ``TensorSlot -> Softmax(last axis)``, return
    the slot name, else None. Layers use this to route the most common sum
    parameterization to the ``*_softmax`` contractions, which normalize the
    logits inside the op (the reparam-fusion requirement of SURVEY §7;
    contrast with the reference where torch evaluates the parameter graph
    eagerly, ``parameters/parameter.py:180-188``)."""
    nodes = list(param.topological_ordering())
    if len(nodes) != 2:
        return None
    slot, sm = nodes
    if not isinstance(slot, JaxTensorSlot) or not isinstance(sm, JaxSoftmaxParameter):
        return None
    if sm.axis != len(slot.shape) - 1:
        return None
    return slot.slot


def _topk_states(lp: jnp.ndarray, t: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-t over a per-state log-score table (F, K, S): (values
    (F, K, t), states (F, K, t)), descending, ``-inf``-padded when t > S."""
    tt = min(t, lp.shape[2])
    vals, idx = jax.lax.top_k(lp, tt)
    if tt < t:
        vals = jnp.concatenate(
            [vals, jnp.full((*vals.shape[:2], t - tt), -jnp.inf, vals.dtype)], axis=2
        )
        idx = jnp.concatenate(
            [idx, jnp.broadcast_to(idx[..., -1:], (*idx.shape[:2], t - tt))], axis=2
        )
    return vals, idx


class JaxLayer(ABC):
    """The abstract compiled layer."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        *,
        arity: int = 1,
        num_folds: int = 1,
        semiring: Semiring | None = None,
    ):
        self.num_input_units = num_input_units
        self.num_output_units = num_output_units
        self.arity = arity
        self.num_folds = num_folds
        self.semiring: Semiring = SumProductSemiring if semiring is None else semiring

    @property
    @abstractmethod
    def config(self) -> Mapping[str, Any]:
        """Static hyperparameters (folding groups on these)."""

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        """Compiled parameter graphs by name."""
        return {}

    @property
    def sub_modules(self) -> Mapping[str, "JaxLayer"]:
        """Nested layers (e.g. the inner layer of an evidence layer)."""
        return {}

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        """Hashable key: layers fold together iff these match."""
        psig = tuple((n, p.fold_settings) for n, p in self.params.items())
        msig = tuple((n, m.fold_settings) for n, m in self.sub_modules.items())
        return (type(self).__name__, *sorted(self.config.items()), psig, msig)

    @abstractmethod
    def forward(self, store: Store, x) -> jnp.ndarray: ...

    def __call__(self, store: Store, x) -> jnp.ndarray:
        return self.forward(store, x)

    def num_parameters(self, store: Store) -> int:
        return sum(
            int(np.prod(store[slot.slot].shape))
            for p in self.params.values()
            for slot in p.tensor_slots()
        )

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(F={self.num_folds}, arity={self.arity}, "
            f"Ki={self.num_input_units}, Ko={self.num_output_units})"
        )


# --------------------------------------------------------------------------- #
# Inner layers
# --------------------------------------------------------------------------- #


class JaxInnerLayer(JaxLayer, ABC):
    """A sum or product layer: (F, H, B, Ki) -> (F, B, Ko)."""

    def sample(self, store: Store, key, x: jnp.ndarray):
        """Route samples upward: x has shape (F, H, K, N, D) of per-unit
        variable assignments; returns ((F, Ko, N, D), mixture indices or
        None) — the reference's ancestral-sampling step
        (ref: ``layers/inner.py:129,189,275``)."""
        raise TypeError(f"Sampling is not supported for {type(self).__name__}")


class JaxHadamardLayer(JaxInnerLayer):
    """Elementwise semiring product over the arity axis."""

    def __init__(self, num_input_units: int, *, arity: int = 2, num_folds: int = 1, semiring=None):
        super().__init__(
            num_input_units, num_input_units, arity=arity, num_folds=num_folds, semiring=semiring
        )

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_input_units": self.num_input_units, "arity": self.arity}

    def forward(self, store: Store, x) -> jnp.ndarray:
        return self.semiring.prod(x, dim=1)

    def sample(self, store, key, x):
        # Disjoint scopes: add the zero-padded per-operand assignments.
        return x.sum(axis=1), None


class JaxKroneckerLayer(JaxInnerLayer):
    """Iterated semiring outer product, flattened row-major (the unit for
    inputs (i_1, ..., i_H) sits at index i_1 * Ki^(H-1) + ... + i_H)."""

    def __init__(self, num_input_units: int, *, arity: int = 2, num_folds: int = 1, semiring=None):
        super().__init__(
            num_input_units,
            int(num_input_units**arity),
            arity=arity,
            num_folds=num_folds,
            semiring=semiring,
        )

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_input_units": self.num_input_units, "arity": self.arity}

    def forward(self, store: Store, x) -> jnp.ndarray:
        out = tmap(lambda a: a[:, 0], x)  # (F, B, Ki)
        for h in range(1, self.arity):
            out = self.semiring.mul(
                tmap(lambda a: a[..., :, None], out),
                tmap(lambda a: a[:, h][..., None, :], x),
            )
            out = tmap(lambda a: a.reshape(a.shape[0], a.shape[1], -1), out)
        return out

    def sample(self, store, key, x):
        # x: (F, H, K, N, D); combine all unit pairings by addition
        out = x[:, 0]
        for h in range(1, self.arity):
            f, k, n, d = out.shape
            out = out[:, :, None] + x[:, h][:, None]  # (F, K, Ki, N, D)
            out = out.reshape(f, -1, n, d)
        return out, None


class JaxSumLayer(JaxInnerLayer):
    """The dense sum layer: a semiring einsum contracting (H, Ki) against a
    (F, Ko, H*Ki) weight. The log-space path is the framework's hottest op
    (ref contract: ``backend/torch/layers/inner.py:200-273``)."""

    def __init__(
        self,
        num_input_units: int,
        num_output_units: int,
        *,
        arity: int = 1,
        weight: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(
            num_input_units, num_output_units, arity=arity, num_folds=num_folds, semiring=semiring
        )
        assert weight.shape == (num_output_units, arity * num_input_units), (
            weight.shape,
            (num_output_units, arity * num_input_units),
        )
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
        def flat(a):
            f, h, b, ki = a.shape
            return jnp.transpose(a, (0, 2, 1, 3)).reshape(f, b, h * ki)

        x = tmap(flat, x)
        if self._logits_slot is not None:
            # Softmax-parameterized weights: the contraction takes the logits
            # and normalizes them itself.
            return self.semiring.matmul_softmax(x, store[self._logits_slot])
        return self.semiring.matmul(x, self.weight(store))

    def sample(self, store, key, x):
        # Latent-variable semantics: each output unit mixes over its H*Ki
        # inputs; draw one input per (fold, unit, sample) and gather its
        # assignment. Requires normalized non-negative weights.
        w = self.weight(store)  # (F, Ko, H*Ki)
        f, h, k, n, d = x.shape
        x = x.reshape(f, h * k, n, d)
        logits = jnp.log(w)  # (F, Ko, H*Ki)
        mix = jax.random.categorical(
            key, jnp.broadcast_to(logits[:, :, None, :], (f, w.shape[1], n, w.shape[2])),
            axis=-1,
        )  # (F, Ko, N)
        # gather along the H*Ki axis for each (f, n): use advanced indexing
        fold_idx = jnp.arange(f)[:, None, None]
        n_idx = jnp.arange(n)[None, None, :]
        out = x[fold_idx, mix, n_idx]  # (F, Ko, N, D)
        return out, mix


# --------------------------------------------------------------------------- #
# Input layers
# --------------------------------------------------------------------------- #


class JaxInputLayer(JaxLayer, ABC):
    """An input layer: consumes the gathered data slice (F, B, D)."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        num_folds: int = 1,
        semiring=None,
    ):
        scope_idx = np.atleast_2d(np.asarray(scope_idx, dtype=np.int32))
        assert scope_idx.shape[0] == num_folds, (scope_idx.shape, num_folds)
        super().__init__(
            scope_idx.shape[1], num_output_units, arity=1, num_folds=num_folds, semiring=semiring
        )
        self.scope_idx = scope_idx

    @property
    def num_variables(self) -> int:
        return self.num_input_units

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        return (self.num_variables, *super().fold_settings)

    def integrate(self, store: Store) -> jnp.ndarray:
        """The layer's integral over its variables' domain: (F, K)."""
        raise TypeError(f"Integration is not supported for {type(self).__name__}")

    def sample(self, store: Store, key, num_samples: int) -> jnp.ndarray:
        """Sample the encoded distribution: (F, K, N)."""
        raise TypeError(f"Sampling is not supported for {type(self).__name__}")

    def mpe(self, store: Store) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Per-unit mode: the (max log-value (F, K), argmax state (F, K))
        pair under the same (possibly unnormalized) measure as ``forward``.
        Drives :class:`cirkit_tpu.backend.jax.queries.MAPQuery` — an
        extension; the reference has no MAP/MPE query."""
        raise TypeError(f"MPE is not supported for {type(self).__name__}")

    def mean_state(self, store: Store) -> jnp.ndarray:
        """Per-unit expected state E[x | unit] of the encoded distribution:
        (F, K). Drives posterior-expectation queries (soft imputation) —
        an extension; not every input layer is a distribution."""
        raise TypeError(f"Expected states are not defined for {type(self).__name__}")

    def second_moment_state(self, store: Store) -> jnp.ndarray:
        """Per-unit second moment E[x^2 | unit]: (F, K). Combined with
        :meth:`mean_state` this yields exact posterior variances
        (uncertainty-aware imputation,
        ``ExpectationQuery(..., return_variance=True)``)."""
        raise TypeError(f"Second moments are not defined for {type(self).__name__}")

    def state_distribution(self, store: Store) -> jnp.ndarray:
        """Per-unit *normalized* finite-support state distribution
        p(x = s | unit): (F, K, S). Drives the posterior-marginals query
        (``ExpectationQuery.marginals``); continuous layers have no finite
        support and raise."""
        raise TypeError(
            f"State distributions are not defined for {type(self).__name__}"
        )

    def cdf_state(self, store: Store, t: jnp.ndarray) -> jnp.ndarray:
        """Per-unit CDF P(x <= t | unit) at per-(fold, sample) thresholds
        ``t`` (F, B): (F, B, K). Drives the posterior CDF/quantile queries
        (``ExpectationQuery.cdf``/``quantile``) — defined for continuous
        leaves too, unlike :meth:`state_distribution`."""
        raise TypeError(f"CDFs are not defined for {type(self).__name__}")

    def unit_entropy(self, store: Store) -> jnp.ndarray:
        """Entropy (nats) of each unit's NORMALIZED distribution: (F, K).
        Drives :class:`cirkit_tpu.backend.jax.entropy.EntropyQuery`."""
        raise TypeError(f"Entropies are not defined for {type(self).__name__}")

    def unit_kl(self, store_p: Store, store_q: Store) -> jnp.ndarray:
        """KL(p || q) (nats) between each unit's NORMALIZED distributions
        under two parameter stores: (F, K). Drives
        :class:`cirkit_tpu.backend.jax.entropy.KLDivergenceQuery`."""
        raise TypeError(f"KL divergences are not defined for {type(self).__name__}")

    def topk_modes(self, store: Store, t: int) -> tuple[jnp.ndarray, jnp.ndarray]:
        """The ``t`` best states per unit, sorted descending: (values
        (F, K, t), states (F, K, t)). Drives the top-k MPE query
        (:mod:`cirkit_tpu.backend.jax.topk`) — an extension; the reference
        has no MAP query at all.

        Base implementation: the (unique) mode followed by ``-inf``
        padding — exact for continuous layers, whose maximizer is a single
        point with no discrete "second best" state. Finite-support layers
        override with an exact per-state top-k."""
        val, arg = self.mpe(store)
        pad = jnp.full((*val.shape, t - 1), -jnp.inf, val.dtype)
        vals = jnp.concatenate([val[..., None], pad], axis=-1)
        states = jnp.broadcast_to(arg[..., None], (*arg.shape, t))
        return vals, states

    def sample_selected(self, store: Store, key, sel: jnp.ndarray) -> jnp.ndarray:
        """One draw per (fold, sample) from the SELECTED unit only: ``sel``
        is an (F, B) unit-index array; returns (F, B) states.

        The lazy counterpart of :meth:`sample` used by the conditional-
        sampling downward pass — only one unit per (fold, sample) is ever
        on the parse, so drawing all K units wastes a K-fold factor of
        noise and traffic (64x on the flagship). The base implementation
        falls back to a full :meth:`sample` plus a gather; the exponential-
        family layers override it to draw only the selected unit."""
        full = jnp.transpose(self.sample(store, key, sel.shape[1]), (0, 2, 1))
        return jnp.take_along_axis(full, sel[:, :, None], axis=2)[:, :, 0]


class JaxConstantInputLayer(JaxInputLayer, ABC):
    """An input layer over the empty scope: forward takes the batch size."""

    def __init__(self, num_output_units: int, *, num_folds: int = 1, semiring=None):
        super().__init__(
            np.empty((num_folds, 0), dtype=np.int32),
            num_output_units,
            num_folds=num_folds,
            semiring=semiring,
        )


def _discrete_cdf(p: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """P(x <= t | unit) from a per-unit state table: ``p`` (F, K, S),
    thresholds ``t`` (F, B) -> (F, B, K). Non-integer thresholds floor
    (step CDF); below-support thresholds give 0, above-support 1."""
    states = jnp.arange(p.shape[2], dtype=p.dtype)
    mask = (states[None, None, :] <= t[:, :, None]).astype(p.dtype)  # (F, B, S)
    return jnp.einsum("fks,fbs->fbk", p, mask, precision=jax.lax.Precision.HIGHEST)


class JaxExpFamilyLayer(JaxInputLayer, ABC):
    """Exponential-family input layers: define the (possibly unnormalized)
    log likelihood and log partition function."""

    def forward(self, store: Store, x) -> jnp.ndarray:
        ll = self.log_unnormalized_likelihood(store, x)
        return self.semiring.map_from(ll, LSESumSemiring)

    def integrate(self, store: Store) -> jnp.ndarray:
        log_z = self.log_partition_function(store)
        return self.semiring.map_from(log_z, LSESumSemiring)

    @abstractmethod
    def log_unnormalized_likelihood(self, store: Store, x) -> jnp.ndarray: ...

    @abstractmethod
    def log_partition_function(self, store: Store) -> jnp.ndarray: ...


class JaxCategoricalLayer(JaxExpFamilyLayer):
    """Categorical units: normalized under probs, unnormalized under logits."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        num_categories: int,
        probs: JaxParameter | None = None,
        logits: JaxParameter | None = None,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        if (logits is None) == (probs is None):
            raise ValueError("Exactly one of 'logits' and 'probs' must be given")
        self.num_categories = num_categories
        self.probs = probs
        self.logits = logits
        # Softmax-parameterized probs (the image_data default): compute
        # log-probs as one fused log_softmax over the raw logits instead of
        # log(softmax(theta)) — skips materializing the (F, K, C) softmax
        # (51 MB on the MNIST flagship) and is the numerically stable form.
        self._probs_logits_slot = None if probs is None else softmax_logits_slot(probs)

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_output_units": self.num_output_units,
            "num_categories": self.num_categories,
        }

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        if self.logits is None:
            return {"probs": self.probs}
        return {"logits": self.logits}

    def _log_probs(self, store: Store) -> jnp.ndarray:
        if self.logits is None:
            if self._probs_logits_slot is not None:
                return jax.nn.log_softmax(store[self._probs_logits_slot], axis=-1)
            return jnp.log(self.probs(store))
        return self.logits(store)

    def log_unnormalized_likelihood(self, store, x):
        xi = x[..., 0].astype(jnp.int32)  # (F, B)
        logits = self._log_probs(store)  # (F, K, N)
        # One-hot selection matmul instead of take_along_axis: identical
        # values (0/1 selection at HIGHEST precision), but the backward is a
        # matmul rather than a scatter-add. Zero-probability categories are
        # clamped from -inf to the finite minimum so the unselected
        # 0 * -inf products cannot produce NaNs (exp still underflows to 0).
        logits = jnp.maximum(logits, jnp.finfo(logits.dtype).min)
        # Clip to the category range: one_hot maps out-of-range indices to an
        # all-zero row (log p = 0, i.e. probability 1), whereas the gather it
        # replaced clamped — keep the clamping semantics.
        xi = jnp.clip(xi, 0, logits.shape[2] - 1)
        onehot = jax.nn.one_hot(xi, logits.shape[2], dtype=logits.dtype)  # (F, B, N)
        return jnp.einsum(
            "fbn,fkn->fbk", onehot, logits, precision=jax.lax.Precision.HIGHEST
        )

    def log_partition_function(self, store):
        if self.logits is None:
            p = self.probs(store)
            return jnp.zeros((self.num_folds, self.num_output_units), dtype=p.dtype)
        return jax.nn.logsumexp(self.logits(store), axis=2)

    def sample(self, store, key, num_samples):
        logits = self._log_probs(store)  # (F, K, N)
        samples = jax.random.categorical(
            key, jnp.broadcast_to(logits, (num_samples, *logits.shape)), axis=-1
        )  # (N, F, K)
        return jnp.transpose(samples, (1, 2, 0))

    def mean_state(self, store):
        p = jax.nn.softmax(self._log_probs(store), axis=2)  # (F, K, C)
        states = jnp.arange(p.shape[2], dtype=p.dtype)
        return jnp.einsum("fkc,c->fk", p, states, precision=jax.lax.Precision.HIGHEST)

    def second_moment_state(self, store):
        p = jax.nn.softmax(self._log_probs(store), axis=2)  # (F, K, C)
        states = jnp.arange(p.shape[2], dtype=p.dtype)
        return jnp.einsum(
            "fkc,c->fk", p, states * states, precision=jax.lax.Precision.HIGHEST
        )

    def state_distribution(self, store):
        # softmax normalizes the logits-parameterized (unnormalized) case
        # to the same measure the responsibilities are computed under
        return jax.nn.softmax(self._log_probs(store), axis=2)  # (F, K, C)

    def cdf_state(self, store, t):
        return _discrete_cdf(self.state_distribution(store), t)

    def unit_entropy(self, store):
        lp = jax.nn.log_softmax(self._log_probs(store), axis=2)  # (F, K, C)
        p = jnp.exp(lp)
        return -jnp.sum(jnp.where(p > 0, p * lp, 0.0), axis=2)

    def unit_kl(self, store_p, store_q):
        lp = jax.nn.log_softmax(self._log_probs(store_p), axis=2)
        lq = jax.nn.log_softmax(self._log_probs(store_q), axis=2)
        p = jnp.exp(lp)
        # p > 0, q = 0 legitimately yields +inf (support violation)
        return jnp.sum(jnp.where(p > 0, p * (lp - lq), 0.0), axis=2)

    def sample_selected(self, store, key, sel):
        logits = self._log_probs(store)  # (F, K, C)
        # floor -inf (zero-probability categories) at -1e30, NOT finfo.min:
        # a reduced-precision operand conversion (TF32, bf16) of the one-hot
        # selection matmul rounds |finfo(f32).min| up to -inf and the
        # 0 * -inf = NaN corruption survives; HIGHEST precision keeps the
        # selected logits exact (a bf16 pass would perturb the draw)
        logits = jnp.maximum(logits, jnp.float32(-1e30).astype(logits.dtype))
        # store-derived unit count, not self.num_output_units: under manual
        # tensor parallelism (queries.TPRouting) the store holds a local
        # unit shard and sel is already shifted into local row space
        oh = jax.nn.one_hot(sel, logits.shape[1], dtype=logits.dtype)
        lsel = jnp.einsum(
            "fbk,fkc->fbc", oh, logits, precision=jax.lax.Precision.HIGHEST
        )  # (F, B, C)
        return jax.random.categorical(key, lsel, axis=-1)

    def mpe(self, store):
        lp = self._log_probs(store)  # (F, K, C), same measure as forward
        return jnp.max(lp, axis=2), jnp.argmax(lp, axis=2)

    def topk_modes(self, store, t):
        lp = self._log_probs(store)  # (F, K, C)
        return _topk_states(lp, t)


class JaxEmbeddingLayer(JaxInputLayer):
    """Embedding units: look up one weight column per observed state."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        num_states: int = 2,
        weight: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        self.num_states = num_states
        self.weight = weight

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_output_units": self.num_output_units,
            "num_states": self.num_states,
        }

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        return {"weight": self.weight}

    def forward(self, store, x):
        xi = x[..., 0].astype(jnp.int32)  # (F, B)
        w = self.weight(store)  # (F, K, N)
        # one-hot selection matmul: see JaxCategoricalLayer (matmul backward);
        # clip like there so out-of-range states clamp instead of zeroing out
        xi = jnp.clip(xi, 0, w.shape[2] - 1)
        onehot = jax.nn.one_hot(xi, w.shape[2], dtype=w.dtype)  # (F, B, N)
        out = jnp.einsum(
            "fbn,fkn->fbk", onehot, w, precision=jax.lax.Precision.HIGHEST
        )
        return self.semiring.map_from(out, SumProductSemiring)

    def integrate(self, store):
        value = self.weight(store).sum(axis=2)  # (F, K)
        return self.semiring.map_from(value, SumProductSemiring)

    def mpe(self, store):
        lw = safelog(self.weight(store))  # (F, K, S)
        return jnp.max(lw, axis=2), jnp.argmax(lw, axis=2)

    def topk_modes(self, store, t):
        return _topk_states(safelog(self.weight(store)), t)

    def state_distribution(self, store):
        # the unit's weights normalized into a distribution over states —
        # exactly the measure the posterior responsibilities weight
        # (the unnormalized factor's integral rides the responsibility);
        # meaningful for nonnegative weights only (the lse-sum semiring,
        # which the expectation queries require)
        w = self.weight(store)  # (F, K, S)
        z = jnp.maximum(w.sum(axis=2, keepdims=True), jnp.finfo(w.dtype).tiny)
        return w / z

    def mean_state(self, store):
        p = self.state_distribution(store)
        states = jnp.arange(p.shape[2], dtype=p.dtype)
        return jnp.einsum("fks,s->fk", p, states, precision=jax.lax.Precision.HIGHEST)

    def second_moment_state(self, store):
        p = self.state_distribution(store)
        states = jnp.arange(p.shape[2], dtype=p.dtype)
        return jnp.einsum(
            "fks,s->fk", p, states * states, precision=jax.lax.Precision.HIGHEST
        )

    def cdf_state(self, store, t):
        return _discrete_cdf(self.state_distribution(store), t)

    def unit_entropy(self, store):
        p = self.state_distribution(store)
        return -jnp.sum(jnp.where(p > 0, p * safelog(p), 0.0), axis=2)

    def unit_kl(self, store_p, store_q):
        p = self.state_distribution(store_p)
        q = self.state_distribution(store_q)
        return jnp.sum(jnp.where(p > 0, p * (safelog(p) - safelog(q)), 0.0), axis=2)


class JaxBinomialLayer(JaxExpFamilyLayer):
    """Binomial units (always normalized)."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        total_count: int = 1,
        probs: JaxParameter | None = None,
        logits: JaxParameter | None = None,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        if (logits is None) == (probs is None):
            raise ValueError("Exactly one of 'logits' and 'probs' must be given")
        self.total_count = total_count
        self.probs = probs
        self.logits = logits

    @property
    def config(self) -> Mapping[str, Any]:
        return {
            "num_output_units": self.num_output_units,
            "total_count": self.total_count,
        }

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        if self.logits is None:
            return {"probs": self.probs}
        return {"logits": self.logits}

    def _logits(self, store) -> jnp.ndarray:
        if self.logits is None:
            p = self.probs(store)
            return jnp.log(p) - jnp.log1p(-p)
        return self.logits(store)

    def log_unnormalized_likelihood(self, store, x):
        n = self.total_count
        k = x[..., 0]  # (F, B), counts
        logits = self._logits(store)[:, None, :]  # (F, 1, K)
        kf = k.astype(logits.dtype)[:, :, None]  # (F, B, 1)
        log_comb = (
            jax.scipy.special.gammaln(n + 1.0)
            - jax.scipy.special.gammaln(kf + 1.0)
            - jax.scipy.special.gammaln(n - kf + 1.0)
        )
        # log pmf = log C(n,k) + k*logits - n*log(1+exp(logits))
        return log_comb + kf * logits - n * jax.nn.softplus(logits)

    def log_partition_function(self, store):
        ref = self._logits(store)
        return jnp.zeros((self.num_folds, self.num_output_units), dtype=ref.dtype)

    def sample(self, store, key, num_samples):
        p = jax.nn.sigmoid(self._logits(store))  # (F, K)
        u = jax.random.uniform(
            key, (num_samples, self.total_count, *p.shape), dtype=p.dtype
        )
        samples = (u < p[None, None]).sum(axis=1)  # (N, F, K)
        return jnp.transpose(samples, (1, 2, 0))

    def sample_selected(self, store, key, sel):
        p = jax.nn.sigmoid(self._logits(store))  # (F, K)
        psel = jnp.take_along_axis(p, sel, axis=1)  # (F, B)
        u = jax.random.uniform(key, (self.total_count, *psel.shape), dtype=p.dtype)
        return (u < psel[None]).sum(axis=0).astype(p.dtype)

    def mean_state(self, store):
        return self.total_count * jax.nn.sigmoid(self._logits(store))  # (F, K)

    def second_moment_state(self, store):
        n = self.total_count
        p = jax.nn.sigmoid(self._logits(store))  # (F, K)
        return n * p * (1.0 - p) + jnp.square(n * p)

    def state_distribution(self, store):
        return jnp.exp(self._log_pmf_table(store))  # (F, K, n+1)

    def cdf_state(self, store, t):
        return _discrete_cdf(self.state_distribution(store), t)

    def unit_entropy(self, store):
        lp = self._log_pmf_table(store)  # (F, K, n+1), normalized
        p = jnp.exp(lp)
        return -jnp.sum(jnp.where(p > 0, p * lp, 0.0), axis=2)

    def unit_kl(self, store_p, store_q):
        # KL(Bin(n, p1) || Bin(n, p2)) = n KL(Bern(p1) || Bern(p2)), in
        # log-space via log sigma(l) = -softplus(-l) for stability
        l1 = self._logits(store_p)
        l2 = self._logits(store_q)
        p1 = jax.nn.sigmoid(l1)
        pos = -jax.nn.softplus(-l1) + jax.nn.softplus(-l2)  # log p1 - log p2
        neg = -jax.nn.softplus(l1) + jax.nn.softplus(l2)  # log(1-p1) - log(1-p2)
        return self.total_count * (p1 * pos + (1.0 - p1) * neg)

    def mpe(self, store):
        logits = self._logits(store)  # (F, K)
        n = self.total_count
        p = jax.nn.sigmoid(logits)
        mode = jnp.clip(jnp.floor((n + 1) * p), 0, n)  # Binomial mode
        log_comb = (
            jax.scipy.special.gammaln(n + 1.0)
            - jax.scipy.special.gammaln(mode + 1.0)
            - jax.scipy.special.gammaln(n - mode + 1.0)
        )
        val = log_comb + mode * logits - n * jax.nn.softplus(logits)
        return val, mode.astype(jnp.int32)

    def _log_pmf_table(self, store) -> jnp.ndarray:
        """The full (F, K, n+1) log-pmf table over counts 0..n."""
        logits = self._logits(store)[:, :, None]  # (F, K, 1)
        n = self.total_count
        counts = jnp.arange(n + 1, dtype=logits.dtype)
        log_comb = (
            jax.scipy.special.gammaln(n + 1.0)
            - jax.scipy.special.gammaln(counts + 1.0)
            - jax.scipy.special.gammaln(n - counts + 1.0)
        )
        return log_comb + counts * logits - n * jax.nn.softplus(logits)

    def topk_modes(self, store, t):
        # the full (n+1)-entry log-pmf table, then an exact top-k over it
        return _topk_states(self._log_pmf_table(store), t)


class JaxGaussianLayer(JaxExpFamilyLayer):
    """Gaussian units, optionally unnormalized via a log-partition parameter."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        mean: JaxParameter,
        stddev: JaxParameter,
        log_partition: JaxParameter | None = None,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        self.mean = mean
        self.stddev = stddev
        self.log_partition = log_partition

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units}

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        p = {"mean": self.mean, "stddev": self.stddev}
        if self.log_partition is not None:
            p["log_partition"] = self.log_partition
        return p

    def log_unnormalized_likelihood(self, store, x):
        mean = self.mean(store)[:, None, :]  # (F, 1, K)
        stddev = self.stddev(store)[:, None, :]
        xi = x[..., :1]  # (F, B, 1)
        z = (xi - mean) / stddev
        ll = -0.5 * jnp.square(z) - jnp.log(stddev) - 0.5 * math.log(2.0 * math.pi)
        if self.log_partition is not None:
            ll = ll + self.log_partition(store)[:, None, :]
        return ll

    def log_partition_function(self, store):
        if self.log_partition is None:
            ref = self.mean(store)
            return jnp.zeros((self.num_folds, self.num_output_units), dtype=ref.dtype)
        return self.log_partition(store)

    def sample(self, store, key, num_samples):
        mean = self.mean(store)  # (F, K)
        stddev = self.stddev(store)
        eps = jax.random.normal(key, (num_samples, *mean.shape), dtype=mean.dtype)
        samples = mean[None] + stddev[None] * eps  # (N, F, K)
        return jnp.transpose(samples, (1, 2, 0))

    def sample_selected(self, store, key, sel):
        mean = jnp.take_along_axis(self.mean(store), sel, axis=1)  # (F, B)
        stddev = jnp.take_along_axis(self.stddev(store), sel, axis=1)
        return mean + stddev * jax.random.normal(key, mean.shape, dtype=mean.dtype)

    def mean_state(self, store):
        return self.mean(store)  # (F, K)

    def second_moment_state(self, store):
        return jnp.square(self.mean(store)) + jnp.square(self.stddev(store))

    def cdf_state(self, store, t):
        z = (t[:, :, None] - self.mean(store)[:, None, :]) / self.stddev(store)[
            :, None, :
        ]
        return jax.scipy.special.ndtr(z)

    def unit_entropy(self, store):
        # differential entropy of N(mu, sigma); a log_partition scaling
        # leaves the normalized distribution (hence its entropy) unchanged
        return 0.5 * (1.0 + math.log(2.0 * math.pi)) + jnp.log(self.stddev(store))

    def unit_kl(self, store_p, store_q):
        mp, sp = self.mean(store_p), self.stddev(store_p)
        mq, sq = self.mean(store_q), self.stddev(store_q)
        return (
            jnp.log(sq / sp)
            + (jnp.square(sp) + jnp.square(mp - mq)) / (2.0 * jnp.square(sq))
            - 0.5
        )

    def mpe(self, store):
        mean = self.mean(store)  # (F, K)
        stddev = self.stddev(store)
        val = -jnp.log(stddev) - 0.5 * math.log(2.0 * math.pi)  # density at mean
        if self.log_partition is not None:
            val = val + self.log_partition(store)
        return val, mean


class JaxConstantValueLayer(JaxConstantInputLayer):
    """A constant vector, possibly encoded in log-space."""

    def __init__(
        self,
        num_output_units: int,
        *,
        log_space: bool = False,
        value: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(num_output_units, num_folds=num_folds, semiring=semiring)
        self.value = value
        self.log_space = log_space
        self._source = LSESumSemiring if log_space else SumProductSemiring

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units, "log_space": self.log_space}

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        return {"value": self.value}

    def forward(self, store, batch_size: int):
        v = self.value(store)  # (F, K)
        v = jnp.broadcast_to(v[:, None, :], (v.shape[0], batch_size, v.shape[1]))
        return self.semiring.map_from(v, self._source)


class JaxEvidenceLayer(JaxConstantInputLayer):
    """Evaluates a wrapped input layer on a stored observation."""

    def __init__(
        self,
        layer: JaxInputLayer,
        *,
        observation: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(layer.num_output_units, num_folds=num_folds, semiring=semiring)
        self.layer = layer
        self.observation = observation

    @property
    def config(self) -> Mapping[str, Any]:
        return {}

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        return {"observation": self.observation}

    @property
    def sub_modules(self) -> Mapping[str, JaxLayer]:
        return {"layer": self.layer}

    def forward(self, store, batch_size: int):
        obs = self.observation(store)[:, None, :]  # (F, 1, D)
        out = self.layer.forward(store, obs)  # (F, 1, K)
        return tmap(
            lambda o: jnp.broadcast_to(o, (o.shape[0], batch_size, o.shape[2])), out
        )

    def sample(self, store, key, num_samples):
        obs = self.observation(store)  # (F, 1)
        return jnp.broadcast_to(
            obs[:, :, None], (self.num_folds, self.num_output_units, num_samples)
        )


class JaxPolynomialLayer(JaxInputLayer):
    """Univariate polynomials evaluated by Horner's method."""

    def __init__(
        self,
        scope_idx: np.ndarray,
        num_output_units: int,
        *,
        degree: int,
        coeff: JaxParameter,
        num_folds: int = 1,
        semiring=None,
    ):
        super().__init__(scope_idx, num_output_units, num_folds=num_folds, semiring=semiring)
        self.degree = degree
        self.coeff = coeff

    @property
    def config(self) -> Mapping[str, Any]:
        return {"num_output_units": self.num_output_units, "degree": self.degree}

    @property
    def params(self) -> Mapping[str, JaxParameter]:
        return {"coeff": self.coeff}

    def forward(self, store, x):
        coeff = self.coeff(store)  # (F, K, deg+1)
        xi = x[..., :1]  # (F, B, 1)
        if jnp.issubdtype(coeff.dtype, jnp.complexfloating):
            xi = xi.astype(coeff.dtype)
        out = jnp.zeros((xi.shape[0], xi.shape[1], coeff.shape[1]), dtype=coeff.dtype)
        for d in range(coeff.shape[-1] - 1, -1, -1):
            out = out * xi + coeff[:, None, :, d]
        return self.semiring.map_from(out, SumProductSemiring)
