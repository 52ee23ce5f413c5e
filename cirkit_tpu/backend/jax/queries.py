"""Queries over compiled circuits: per-sample marginals and sampling.

Rebuild of ``cirkit/backend/torch/queries.py:19-275``, jit-native: both
queries compile to *plan variants* of the same evaluation plan — the same
step list with input-layer steps swapped. The integration mask is a runtime
argument, so one jitted function serves all per-sample marginal queries
without recompilation.
"""

from __future__ import annotations

from abc import ABC
from collections.abc import Sequence
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.circuit import JaxCircuit, _pad_rows, _slice_rows
from cirkit_tpu.backend.jax.layers import JaxInnerLayer, JaxInputLayer, JaxLayer
from cirkit_tpu.backend.jax.parameters import JaxMatMulParameter, Store
from cirkit_tpu.utils.scope import Scope


class Query(ABC):
    """A query object over a compiled circuit."""


def masked_leaf_select(layer: JaxLayer, store: Store, out, mask: jnp.ndarray):
    """``where(mask-at-scope, integral, out)`` for an input layer — THE
    masked-integrate select, shared by every marginalization consumer
    (IntegrateQuery / missing-data losses / EM / expectations) so the
    multivariate policy lives in one place. ``mask`` is (B, D) with True =
    marginalize this variable. Non-input (and empty-scope) layers pass
    through; multivariate input layers raise."""
    if not isinstance(layer, JaxInputLayer) or layer.num_variables == 0:
        return out
    if layer.num_variables > 1:
        raise NotImplementedError(
            "Integration of multivariate input layers is not supported"
        )
    # mask gathered at the layer's scope: (B, F, 1) -> (F, B, 1)
    m = jnp.transpose(mask[:, layer.scope_idx[:, 0]], (1, 0))[:, :, None]
    return jax.tree_util.tree_map(
        lambda iz, o: jnp.where(m, iz[:, None, :], o),
        layer.integrate(store),
        out,
    )


def masked_evaluate(
    cc: JaxCircuit, store: Store, x: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """(B, O, K) log-likelihoods with the ``mask``-ed (True) variables
    marginalized out — the :class:`IntegrateQuery` evaluation as a plain
    trace-time function, composable inside training losses (missing-data
    MLE/EM) and custom jitted programs. ``mask`` is a (B, D) boolean
    array; entries of ``x`` under the mask are ignored (their input layers
    contribute their integral)."""

    def layer_fn(layer: JaxLayer, s, xin):
        return masked_leaf_select(layer, s, layer(s, xin), mask)

    return cc.evaluate(store, x, module_fn=layer_fn)


def soft_leaf_select(layer: JaxLayer, store: Store, out, soft_mask, logw):
    """Virtual (soft) evidence select for an input layer: where
    ``soft_mask`` is True at the layer's variable, the leaf contributes
    ``log sum_s w(s) f(s)`` — Pearl's virtual-evidence message, i.e. the
    leaf contracted against per-state observation weights ``w`` instead of
    evaluated at a hard state. ``soft_mask`` is (B, D) boolean; ``logw`` is
    (B, D, S) LOG-weights over each soft variable's states (a shorter S
    pads with -inf = zero weight; longer truncates). Computed as a
    max-shifted exp-weighted contraction over the leaf's normalized state
    table times its integral, so it is exact under both the lse-sum and
    sum-product semirings. Continuous leaves have no finite state table
    and pass through — callers validate that soft variables are
    finite-support. An extension: the reference has no virtual-evidence
    surface (``backend/torch/queries.py:19`` has integrate/sample only)."""
    if not isinstance(layer, JaxInputLayer) or layer.num_variables == 0:
        return out
    if layer.num_variables > 1:
        raise NotImplementedError(
            "Soft evidence on multivariate input layers is not supported"
        )
    if _leaf_support_size(layer) is None:
        return out  # continuous leaf: the query wrapper validates these away
    from cirkit_tpu.backend.jax.semiring import LSESumSemiring
    from cirkit_tpu.backend.jax.utils import safelog

    sm = jnp.transpose(soft_mask[:, layer.scope_idx[:, 0]], (1, 0))[:, :, None]
    sd = layer.state_distribution(store)  # (F, K, S) normalized
    iz = layer.integrate(store)  # (F, K) carrier: the factor's total mass
    lw = jnp.transpose(logw[:, layer.scope_idx[:, 0], :], (1, 0, 2))  # (F, B, S')
    s = sd.shape[2]
    if lw.shape[2] < s:
        lw = jnp.pad(
            lw, ((0, 0), (0, 0), (0, s - lw.shape[2])), constant_values=-jnp.inf
        )
    elif lw.shape[2] > s:
        lw = lw[:, :, :s]
    # log sum_s exp(lw_s) p(s), max-shifted; the -1e30 floor guards all--inf
    # rows (zero-weight everywhere) from producing NaN through the shift —
    # NOT finfo.min, which a TF32/bf16 operand conversion rounds to -inf
    m = jnp.maximum(jnp.max(lw, axis=2), -1e30)  # (F, B)
    wexp = jnp.exp(lw - m[:, :, None])
    val = jnp.einsum("fbs,fks->fbk", wexp, sd, precision=jax.lax.Precision.HIGHEST)
    logv = safelog(val) + m[:, :, None]
    sem = layer.semiring
    weighted = sem.mul(sem.map_from(logv, LSESumSemiring), iz[:, None, :])
    return jax.tree_util.tree_map(lambda w, o: jnp.where(sm, w, o), weighted, out)


def soft_evaluate(
    cc: JaxCircuit,
    store: Store,
    x: jnp.ndarray,
    mask: jnp.ndarray,
    soft_mask: jnp.ndarray,
    logw: jnp.ndarray,
) -> jnp.ndarray:
    """(B, O, K) log-likelihoods with the ``mask``-ed (True) variables
    marginalized out AND the ``soft_mask``-ed variables observed as
    *virtual evidence* with per-state log-weights ``logw`` (B, D, S) —
    the trace-time composable behind ``IntegrateQuery(..., soft_vars=,
    soft_weights=)``. A variable under both masks is marginalized (the
    query wrapper validates the masks disjoint)."""

    def layer_fn(layer: JaxLayer, s, xin):
        out = soft_leaf_select(layer, s, layer(s, xin), soft_mask, logw)
        return masked_leaf_select(layer, s, out, mask)

    return cc.evaluate(store, x, module_fn=layer_fn)


class IntegrateQuery(Query):
    """Per-sample marginalization without recompiling: input-layer steps
    select between the layer's output and its integral with a (B, D) boolean
    mask passed at run time."""

    def __init__(self, circuit: JaxCircuit) -> None:
        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                f"The circuit to integrate must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        self._circuit = circuit

    def __call__(
        self,
        x: jnp.ndarray,
        *,
        integrate_vars: jnp.ndarray | np.ndarray | Scope | Sequence[Scope] | None = None,
        store: Store | None = None,
        pad_batch_to: int | None = None,
        soft_vars: jnp.ndarray | np.ndarray | Scope | Sequence[Scope] | None = None,
        soft_weights: jnp.ndarray | np.ndarray | None = None,
    ) -> jnp.ndarray:
        """Evaluate marginals: ``integrate_vars`` is a (B, D) or (D,) boolean
        mask (True = marginalized), a Scope, or a sequence of Scopes of
        length 1 or B. ``pad_batch_to`` rounds ragged serving batches up to
        a multiple so one compiled program serves every size (array or
        broadcastable specs only).

        ``soft_vars``/``soft_weights`` add **virtual (soft) evidence**
        (Pearl 1988): each soft variable contributes ``sum_s w(s) p(x=s)``
        instead of a hard observation — the likelihood of an unreliable
        sensor reading with per-state weights. ``soft_vars`` selects the
        variables (same specs as ``integrate_vars``) and ``soft_weights``
        is a (B, D, S) or (D, S) array of nonnegative linear-space weights
        over each soft variable's states (rows for non-soft variables are
        ignored). Uniform weights reduce to marginalization and a one-hot
        row to hard evidence — both pinned by tests. Soft variables must
        be finite-support (categorical/binomial/embedding leaves) and
        disjoint from ``integrate_vars``; entries of ``x`` under soft
        variables are ignored. Both masks are runtime arguments — one
        compiled program serves every pattern."""
        cc = self._circuit
        if (soft_vars is None) != (soft_weights is None):
            raise ValueError("soft_vars and soft_weights must be passed together")
        if integrate_vars is None and soft_vars is None:
            raise ValueError(
                "Pass integrate_vars (marginalization) and/or "
                "soft_vars + soft_weights (virtual evidence)"
            )
        if soft_vars is None:
            x, integrate_vars, _b = _pad_rows(pad_batch_to, x, integrate_vars)
        else:
            # normalize the weights to (B, D, S) host-side BEFORE padding so
            # the row padder treats them like any per-row mask ((D, S) specs
            # broadcast; a (D, S) array with D == B would otherwise be
            # ambiguous to the padder)
            soft_weights = np.asarray(soft_weights, dtype=np.float32)
            if soft_weights.ndim == 2:
                soft_weights = np.broadcast_to(
                    soft_weights[None], (np.shape(x)[0], *soft_weights.shape)
                )
            x, integrate_vars, soft_vars, soft_weights, _b = _pad_rows(
                pad_batch_to, x, integrate_vars, soft_vars, soft_weights
            )
        num_vars = max(cc.scope) + 1
        if integrate_vars is None:
            mask = jnp.zeros((x.shape[0], num_vars), dtype=jnp.bool_)
        else:
            mask = self._as_mask(integrate_vars, x.shape[0])

        if store is None:
            store = getattr(cc, "default_store", None)
            if store is None:
                raise ValueError("No parameter store bound; pass store=...")
        store = cc.restrict_store(store)

        if soft_vars is not None:
            soft_mask = self._as_mask(soft_vars, x.shape[0])
            both = np.asarray(mask) & np.asarray(soft_mask)
            if both.any():
                raise ValueError(
                    "A variable cannot be both marginalized and soft-observed: "
                    f"overlap at variables {sorted(set(np.nonzero(both)[1].tolist()))}"
                )
            supports = _variable_supports(cc)
            used = np.asarray(soft_mask).any(axis=0)
            bad = [int(v) for v in np.nonzero(used)[0] if supports[v] <= 0]
            if bad:
                raise ValueError(
                    "Soft evidence requires finite-support leaves; variables "
                    f"{bad} are continuous or have no input layer"
                )
            w = np.asarray(soft_weights, dtype=np.float32)
            if w.ndim != 3 or w.shape[0] != x.shape[0] or w.shape[1] != num_vars:
                raise ValueError(
                    f"soft_weights must be (B, D, S) or (D, S) with B={x.shape[0]}, "
                    f"D={num_vars}; found {w.shape}"
                )
            if np.isnan(w).any() or (w < 0).any():
                raise ValueError("soft_weights must be nonnegative (linear space)")
            with np.errstate(divide="ignore"):
                logw = jnp.asarray(np.log(w))
            fn = getattr(cc, "_soft_integrate_jit", None)
            if fn is None:
                from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

                fn = CachedJit(
                    lambda st, xx, mk, sm, lw: soft_evaluate(cc, st, xx, mk, sm, lw),
                    name="soft_integrate", key_parts=(circuit_fingerprint(cc),),
                )
                cc._soft_integrate_jit = fn
            return _slice_rows(fn(store, jnp.asarray(x), mask, soft_mask, logw), _b)

        # The jitted variant is cached on the circuit, not the query object:
        # constructing a fresh IntegrateQuery(cc) must not pay a retrace.
        fn = getattr(cc, "_integrate_jit", None)
        if fn is None:
            # warm-compile cache (backend/jax/warmcache.py): second
            # processes deserialize the query executable instead of
            # compiling it
            from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

            fn = CachedJit(
                lambda st, xx, mk: masked_evaluate(cc, st, xx, mk),
                name="integrate", key_parts=(circuit_fingerprint(cc),),
            )
            cc._integrate_jit = fn
        return _slice_rows(fn(store, jnp.asarray(x), mask), _b)

    def _as_mask(self, spec, batch: int) -> jnp.ndarray:
        """Normalize a variable spec (mask / Scope / Scope list) to a
        (B, D) boolean mask broadcast to the batch."""
        cc = self._circuit
        if isinstance(spec, (jnp.ndarray, np.ndarray)):
            mask = jnp.asarray(spec)
            if mask.dtype != jnp.bool_:
                raise ValueError(f"Expected a boolean mask, found dtype {mask.dtype}")
            if mask.ndim == 1:
                mask = mask[None]
            num_vars = max(cc.scope) + 1
            if mask.shape[1] != num_vars:
                raise ValueError(
                    f"The circuit scope has {num_vars} variables, but the mask "
                    f"covers {mask.shape[1]}"
                )
        else:
            mask = jnp.asarray(IntegrateQuery.scopes_to_mask(cc, spec))
        if mask.shape[0] not in (1, batch):
            raise ValueError(
                "The number of integration scopes must be 1 (broadcast) or "
                f"match the batch size: found {mask.shape[0]} != {batch}"
            )
        if mask.shape[0] == 1:
            mask = jnp.broadcast_to(mask, (batch, mask.shape[1]))
        return mask

    @staticmethod
    def scopes_to_mask(
        circuit: JaxCircuit, batch_integrate_vars: Scope | Sequence[Scope]
    ) -> np.ndarray:
        """Scopes -> (B, num_vars) boolean mask."""
        if isinstance(batch_integrate_vars, Scope):
            batch_integrate_vars = [batch_integrate_vars]
        num_vars = max(circuit.scope) + 1
        mask = np.zeros((len(batch_integrate_vars), num_vars), dtype=bool)
        for i, scope in enumerate(batch_integrate_vars):
            invalid = Scope(scope) - circuit.scope
            if invalid:
                raise ValueError(
                    "The variables to marginalize must be a subset of the circuit "
                    f"scope; invalid variables: {list(invalid)}"
                )
            mask[i, list(scope)] = True
        return mask


class SamplingQuery(Query):
    """Ancestral sampling through the evaluation plan: input layers sample
    their units' distributions, product layers combine disjoint assignments,
    sum layers draw latent mixture indices and route child samples."""

    def __init__(
        self,
        circuit: JaxCircuit,
        *,
        mesh=None,
        model_axis: str = "model",
        data_axis: str | None = "data",
    ) -> None:
        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                f"The circuit to sample from must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        self._circuit = circuit
        # mesh: tensor-parallel routing via shard_map — see MAPQuery; applies
        # to the two-pass (lse-sum) paths, i.e. conditional() and the
        # unconditional draw on lse-sum circuits
        self._mesh = mesh
        self._model_axis = model_axis
        self._data_axis = data_axis
        # shared across query objects: one traced program per sample count
        if not hasattr(circuit, "_sampling_jit"):
            circuit._sampling_jit = {}
        self._jit_cache: dict[int, object] = circuit._sampling_jit

    def __call__(
        self, num_samples: int = 1, *, key: jax.Array | None = None, store: Store | None = None
    ) -> tuple[jnp.ndarray, list[jnp.ndarray]]:
        """Draw samples: returns (samples of shape (N, D), per-layer latent
        mixture samples).

        On ``lse-sum`` circuits this routes through the scalable two-pass
        machinery (conditional sampling with no evidence), whose memory is
        activation-sized; other semirings use the padded bottom-up routing,
        which is quadratic in the variable count (the reference's own
        representation, ``queries.py:262-275``)."""
        if num_samples <= 0:
            raise ValueError("The number of samples must be a positive number")
        cc = self._circuit
        if key is None:
            key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
        if store is None:
            store = getattr(cc, "default_store", None)
            if store is None:
                raise ValueError("No parameter store bound; pass store=...")
        store = cc.restrict_store(store)
        num_vars = max(cc.scope) + 1

        from cirkit_tpu.backend.jax.semiring import LSESumSemiring

        if cc.semiring is LSESumSemiring:
            fn = _routing_jit(
                cc, "sample", 0, 0,
                mesh=self._mesh, model_axis=self._model_axis, data_axis=self._data_axis,
            )
            x = jnp.zeros((num_samples, num_vars))
            mask = jnp.zeros((num_samples, num_vars), dtype=bool)
            samples, _, mixtures = fn(store, x, mask, key=key)
            return samples, list(mixtures)

        if self._mesh is not None:
            raise NotImplementedError(
                "Tensor-parallel sampling requires the 'lse-sum' semiring "
                "(the dense bottom-up path is single-device)"
            )
        if num_samples not in self._jit_cache:

            def _run(st, k):
                mixtures: list[jnp.ndarray] = []
                keys = iter(jax.random.split(k, len(cc.layers)))

                def layer_fn(layer: JaxLayer, s, xin):
                    lk = next(keys)
                    if isinstance(layer, JaxInputLayer):
                        samples = layer.sample(s, lk, num_samples)  # (F, K, N)
                        return _pad_samples(samples, layer.scope_idx, num_vars)
                    assert isinstance(layer, JaxInnerLayer)
                    out, mix = layer.sample(s, lk, xin)
                    if mix is not None:
                        mixtures.append(mix)
                    return out

                out = cc.evaluate_raw(st, None, module_fn=layer_fn)  # (O, K, N, D)
                return out, tuple(mixtures)

            self._jit_cache[num_samples] = jax.jit(_run)
        out, mixtures = self._jit_cache[num_samples](store, key)
        samples = jnp.transpose(out, (2, 0, 1, 3))[:, 0, 0]  # (N, D)
        return samples, list(mixtures)

    def conditional(
        self,
        x: jnp.ndarray | np.ndarray,
        *,
        evidence_mask: jnp.ndarray | np.ndarray,
        key: jax.Array | None = None,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Posterior sampling given evidence — an extension: the reference
        documents this as not implemented (ref: ``queries.py:191-194``).

        Draws one completion per row: free entries of ``x`` (where
        ``evidence_mask`` is False) are replaced by a sample from
        ``p(x_free | x_obs)``. Returns ``(samples (B, D), log_evidence
        (B,))`` where the value is ``log p(x_obs)`` (free variables
        marginalized). One jitted program serves every mask; tile rows to
        draw several completions of the same evidence. Requires normalized
        sum weights and the ``lse-sum`` semiring (as :class:`MAPQuery`).

        Root contract: the completion is drawn from the distribution of ONE
        root output unit — flat output ``output``, unit ``unit`` (defaults
        (0, 0)) — and the returned ``log_evidence`` is that unit's value.
        On circuits with several root units (e.g. class-conditional roots)
        pass the target head; each (output, unit) pair compiles its own
        cached program.
        """
        from cirkit_tpu.backend.jax.semiring import LSESumSemiring

        cc = self._circuit
        if cc.semiring is not LSESumSemiring:
            raise ValueError(
                "Conditional sampling requires a circuit compiled under the "
                f"'lse-sum' semiring, found {cc.semiring.__name__}"
            )
        num_vars = max(cc.scope) + 1
        x, evidence_mask, _b = _pad_rows(pad_batch_to, x, evidence_mask)
        x = jnp.asarray(x)
        mask = _evidence_to_mask(cc, evidence_mask, x.shape[0])
        if mask.shape[1] != num_vars:
            raise ValueError(
                f"The circuit scope has {num_vars} variables, but the mask "
                f"covers {mask.shape[1]}"
            )
        if key is None:
            key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
        if store is None:
            store = getattr(cc, "default_store", None)
            if store is None:
                raise ValueError("No parameter store bound; pass store=...")
        store = cc.restrict_store(store)

        fn = _routing_jit(
            cc, "sample", output, unit,
            mesh=self._mesh, model_axis=self._model_axis, data_axis=self._data_axis,
        )
        asg, vals, _ = fn(store, x, mask, key=key)  # (B, D), (O, B, K)
        return _slice_rows((asg, vals[output, :, unit]), _b)


class ExpectationQuery(Query):
    """Posterior expected states — soft imputation: ``E[x_v | x_obs]`` for
    every free variable, per sample, in ONE forward+backward pass. An
    extension; the reference has no expectation machinery.

    Mechanism (the EM flow trick, per sample): the gradient of the root
    log-likelihood with respect to a zero additive offset on each input
    unit's log-output is that unit's posterior responsibility
    ``p(unit used | x_obs)`` (smoothness makes them sum to 1 per
    variable), so the posterior mean is the responsibility-weighted sum of
    the units' expected states (``mean_state``: Gaussian mean, categorical
    ``sum_c p_c c``, binomial ``n p``). Exact — unlike MAP this involves
    no max-product relaxation. Observed entries return their ``x`` value.
    """

    def __init__(self, circuit: JaxCircuit) -> None:
        from cirkit_tpu.backend.jax.semiring import LSESumSemiring

        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                f"The circuit must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        if circuit.semiring is not LSESumSemiring:
            raise ValueError(
                "ExpectationQuery requires a circuit compiled under the "
                f"'lse-sum' semiring, found {circuit.semiring.__name__}"
            )
        self._circuit = circuit

    def __call__(
        self,
        x: jnp.ndarray | np.ndarray,
        *,
        evidence_mask: jnp.ndarray | np.ndarray,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        return_variance: bool = False,
        pad_batch_to: int | None = None,
    ) -> jnp.ndarray | tuple[jnp.ndarray, jnp.ndarray]:
        """Return (B, D) expected states: ``x`` where ``evidence_mask`` is
        True, the posterior mean of head (``output``, ``unit``) elsewhere.

        With ``return_variance=True`` also return the (B, D) exact
        posterior variances ``Var[x_v | x_obs]`` (0 at observed entries):
        the same single backward pass supplies the responsibilities, and
        the leaves' ``second_moment_state`` (law of total variance over
        units) finishes the job — uncertainty-aware imputation."""
        mode = "mean_var" if return_variance else "mean"
        return self._dispatch(
            mode, x, evidence_mask, store, output, unit, pad=pad_batch_to
        )

    def marginals(
        self,
        x: jnp.ndarray | np.ndarray,
        *,
        evidence_mask: jnp.ndarray | np.ndarray,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        dtype=None,
        pad_batch_to: int | None = None,
    ) -> jnp.ndarray:
        """Full posterior state distributions in one backward pass:
        (B, D, S) with ``out[b, v, s] = p(x_v = s | x_obs)`` under head
        (``output``, ``unit``), where S is the largest leaf support
        (smaller-support variables zero-pad). Observed variables return
        the one-hot of their observed state. Requires every input layer
        to have finite support (categorical / binomial / embedding);
        continuous leaves raise. ``dtype=jnp.bfloat16`` halves the
        materialized (B, D, S) table (411 -> 205 MB per flagship batch;
        the responsibilities still reduce in f32, only the output rounds,
        ~3e-5 abs err). Measured speed-NEUTRAL on the flagship — the
        table write overlaps the backward (docs/PERF.md) — so it buys
        memory/transfer headroom, not time."""
        mode = "marginals" if dtype is None else f"marginals:{jnp.dtype(dtype).name}"
        return self._dispatch(
            mode, x, evidence_mask, store, output, unit, pad=pad_batch_to
        )

    def cdf(
        self,
        x: jnp.ndarray | np.ndarray,
        *,
        t: jnp.ndarray | np.ndarray | float,
        evidence_mask: jnp.ndarray | np.ndarray,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> jnp.ndarray:
        """Exact posterior CDFs: (B, D) with ``out[b, v] = p(x_v <= t_v |
        x_obs)``. ``t`` broadcasts from a scalar, (D,), or (B, D) array of
        thresholds. The same single responsibility backward as the other
        expectation statistics, contracted with the leaves' per-unit CDFs
        (``cdf_state``: Gaussian ``Phi``, categorical/binomial/embedding
        step CDFs) — so it works on *continuous* leaves, where
        :meth:`marginals` has no finite support and raises. Observed
        entries return the indicator ``x_v <= t_v``."""
        x = jnp.asarray(x)
        num_vars = max(self._circuit.scope) + 1
        tt = jnp.broadcast_to(
            jnp.asarray(t, jnp.result_type(float)), (x.shape[0], num_vars)
        )
        return self._dispatch(
            "cdf", x, evidence_mask, store, output, unit, extra=(tt,),
            pad=pad_batch_to,
        )

    def quantile(
        self,
        x: jnp.ndarray | np.ndarray,
        *,
        q: jnp.ndarray | np.ndarray | float,
        evidence_mask: jnp.ndarray | np.ndarray,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> jnp.ndarray:
        """Exact posterior quantiles — calibrated imputation intervals:
        (B, D) with ``out[b, v] = inf{t : p(x_v <= t | x_obs) >= q_v}``
        (the generalized inverse, so discrete leaves land exactly on the
        quantile state). ``q`` broadcasts from a scalar, (D,), or (B, D);
        e.g. ``q=0.05`` / ``q=0.95`` bracket a 90% posterior interval
        around the :meth:`__call__` mean. The responsibilities are
        computed once; the inversion bisects only through the cheap
        leaf-CDF contraction inside one jitted program (12 bracket
        doublings + 60 bisections). Observed entries return their ``x``
        value."""
        qv = np.asarray(q, dtype=float)
        if ((qv <= 0.0) | (qv >= 1.0)).any():
            raise ValueError("Quantile targets must lie strictly in (0, 1)")
        x = jnp.asarray(x)
        num_vars = max(self._circuit.scope) + 1
        qq = jnp.broadcast_to(
            jnp.asarray(qv, jnp.result_type(float)), (x.shape[0], num_vars)
        )
        return self._dispatch(
            "quantile", x, evidence_mask, store, output, unit, extra=(qq,),
            pad=pad_batch_to,
        )

    def covariance(
        self,
        x: jnp.ndarray | np.ndarray,
        *,
        evidence_mask: jnp.ndarray | np.ndarray,
        variables: Sequence[int],
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        pad_batch_to: int | None = None,
    ) -> jnp.ndarray:
        """Exact posterior covariances ``Cov[x_u, x_v | x_obs]`` for the
        queried ``variables``: (B, k, k) with k = len(variables).

        Off-diagonals come from the Hessian of the evidence log-likelihood
        with respect to the per-unit log-output offsets, contracted with
        the leaves' mean states (one jvp-over-grad pass PER queried
        variable — cost is linear in k, so query the subset you need, not
        all D). Diagonals are the exact posterior variances (law of total
        variance, as in ``return_variance``). Rows/columns of observed
        variables are 0 per sample (conditioning makes them constants)."""
        cc = self._circuit
        variables = tuple(int(v) for v in variables)
        num_vars = max(cc.scope) + 1
        for v in variables:
            if not 0 <= v < num_vars:
                raise ValueError(f"variable {v} out of range for {num_vars} variables")
        # the queried variable is a RUNTIME argument of one compiled row
        # program (k cheap dispatches, no per-subset retrace)
        m1, var = self._dispatch(
            "mean_var", x, evidence_mask, store, output, unit, pad=pad_batch_to
        )
        rows = jnp.stack(
            [
                self._dispatch(
                    "cov_row", x, evidence_mask, store, output, unit,
                    extra=(jnp.int32(u),), pad=pad_batch_to,
                )
                for u in variables
            ],
            axis=1,
        )  # (B, k, D)
        vidx = jnp.asarray(variables)
        cov = rows[:, :, vidx]
        eye = jnp.eye(len(variables), dtype=bool)
        cov = jnp.where(eye[None], var[:, vidx][:, :, None], cov)
        mask = _evidence_to_mask(cc, evidence_mask, jnp.asarray(x).shape[0])
        free = (~mask[:, vidx]).astype(cov.dtype)  # observed vars are constants
        return cov * free[:, :, None] * free[:, None, :]

    def _dispatch(
        self, mode, x, evidence_mask, store, output, unit, extra=(), pad=None
    ):
        cc = self._circuit
        padded = _pad_rows(pad, x, evidence_mask, *extra)
        x, evidence_mask, extra, _b = padded[0], padded[1], padded[2:-1], padded[-1]
        x = jnp.asarray(x)
        mask = _evidence_to_mask(cc, evidence_mask, x.shape[0])
        num_vars = max(cc.scope) + 1
        if mask.shape[1] != num_vars:
            raise ValueError(
                f"The circuit scope has {num_vars} variables, but the mask "
                f"covers {mask.shape[1]}"
            )
        if store is None:
            store = getattr(cc, "default_store", None)
            if store is None:
                raise ValueError("No parameter store bound; pass store=...")
        store = cc.restrict_store(store)
        cache = getattr(cc, "_expect_jits", None)
        if cache is None:
            cache = cc._expect_jits = {}
        key = (output, unit, mode)
        if key not in cache:
            run = _build_expectation_run(cc, output, unit, mode)
            from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

            cache[key] = CachedJit(
                run, name="expectation",
                key_parts=(circuit_fingerprint(cc), key),
            )
        return _slice_rows(cache[key](store, x, mask, *extra), _b)


def _leaf_support_size(layer) -> int | None:
    """Static finite-support size of an input layer, None if continuous."""
    from cirkit_tpu.backend.jax.layers import (
        JaxBinomialLayer,
        JaxCategoricalLayer,
        JaxEmbeddingLayer,
    )

    if isinstance(layer, JaxCategoricalLayer):
        return layer.num_categories
    if isinstance(layer, JaxBinomialLayer):
        return layer.total_count + 1
    if isinstance(layer, JaxEmbeddingLayer):
        return layer.num_states
    return None


def _build_expectation_run(cc: JaxCircuit, output: int, unit: int, mode: str = "mean"):
    """``mode``: "mean" -> (B, D) posterior means; "mean_var" -> the
    ((B, D), (B, D)) mean/variance pair; "marginals" -> (B, D, S) full
    posterior state distributions; "cov_row" -> the (B, D) covariance row
    Cov[x_u, x_.] for a RUNTIME variable index u (one Hessian-vector
    product, tangent = u's leaf mean states). All modes share the same
    offset-gradient responsibility program and differ only in the
    per-leaf statistic (and, for covariance rows, the extra jvp)."""
    from cirkit_tpu.backend.jax.layers import JaxConstantInputLayer

    num_vars = max(cc.scope) + 1
    inputs = [
        (e, entry.layer)
        for e, entry in enumerate(cc._entries)
        if isinstance(entry.layer, JaxInputLayer)
        and not isinstance(entry.layer, JaxConstantInputLayer)
    ]
    for _, layer in inputs:
        if layer.num_variables != 1:
            raise NotImplementedError(
                "Expectations of multivariate input layers are not supported"
            )
    out_dtype = None
    if mode.startswith("marginals:"):
        mode, out_dtype = "marginals", jnp.dtype(mode.split(":", 1)[1])
    supp = 0
    if mode in ("marginals", "mi_row"):
        for _, layer in inputs:
            s = _leaf_support_size(layer)
            if s is None:
                raise NotImplementedError(
                    "Posterior marginals need finite-support input layers; "
                    f"{type(layer).__name__} is continuous"
                )
            supp = max(supp, s)
    off_name = {id(layer): f"__r{e}" for e, layer in inputs}

    def _run(st, xx, mk, uu=None, vv=None):
        if mode == "mi_row":
            # One anchor's full MI row with the anchor index as a RUNTIME
            # scalar: the anchor-state evidence enumeration (S, D) is built
            # ON DEVICE from the tiny base assignment, so the per-anchor
            # host->device traffic is ~bytes instead of a ~800 KB/anchor
            # evidence upload; the KL reduce below runs in the SAME
            # program, so only the (D,) row ever leaves the device.
            x0i, m0i, marg_t = xx[0], mk[0], vv
            colb = jnp.arange(num_vars) == uu
            xx = jnp.where(
                colb[None, :],
                jnp.arange(supp, dtype=xx.dtype)[:, None],
                x0i[None, :],
            )
            mk = m0i[None, :] | colb[None, :]
        bsz = xx.shape[0]
        dt = jnp.result_type(float)
        offs = {
            f"__r{e}": jnp.zeros((layer.num_folds, bsz, layer.num_output_units), dt)
            for e, layer in inputs
        }

        def total_ll(o):
            def layer_fn(layer, s, xin):
                out = layer(s, xin)
                name = off_name.get(id(layer))
                if name is None:
                    return out
                m = jnp.transpose(mk[:, layer.scope_idx[:, 0]], (1, 0))[:, :, None]
                out = jnp.where(m, out, layer.integrate(s)[:, None, :])
                return out + o[name]

            ll = cc.evaluate(st, xx, module_fn=layer_fn)
            return jnp.sum(ll[:, output, unit])

        grad_fn = jax.grad(total_ll)
        resp = grad_fn(offs)
        hp = jax.lax.Precision.HIGHEST

        def contract(rd, stat):
            """Scatter the ``rd``-weighted per-unit statistic (F, K) ->
            (B, D) at each layer's variable position."""
            acc = jnp.zeros((bsz, num_vars), dt)
            for e, layer in inputs:
                r = rd[f"__r{e}"]  # (F, B, K)
                exp = jnp.einsum(
                    "fbk,fk->fb", r, stat(layer).astype(dt), precision=hp
                )
                onehot = jax.nn.one_hot(layer.scope_idx[:, 0], num_vars, dtype=dt)
                acc = acc + jnp.einsum("fb,fd->bd", exp, onehot, precision=hp)
            return acc

        def weighted(stat):
            return contract(resp, stat)

        def cdf_at(tt):
            """Posterior CDF (B, D) at thresholds ``tt`` (B, D): the
            responsibility-weighted per-unit leaf CDFs (responsibilities
            sum to 1 per variable by smoothness, so this is normalized)."""
            acc = jnp.zeros((bsz, num_vars), dt)
            for e, layer in inputs:
                t_f = jnp.transpose(tt[:, layer.scope_idx[:, 0]], (1, 0))  # (F, B)
                c = layer.cdf_state(st, t_f).astype(dt)  # (F, B, K)
                val = jnp.einsum(
                    "fbk,fbk->fb", resp[f"__r{e}"].astype(dt), c, precision=hp
                )
                onehot = jax.nn.one_hot(layer.scope_idx[:, 0], num_vars, dtype=dt)
                acc = acc + jnp.einsum("fb,fd->bd", val, onehot, precision=hp)
            return acc

        if mode == "cov_row":
            # Cov(x_u, x_v | e) = m_u^T H_uv m_v with H the Hessian of the
            # evidence log-likelihood wrt the per-unit offsets (the usage-
            # indicator covariance): one jvp over the grad program with
            # tangent = u's mean states gives the full row; u is a traced
            # scalar, so ONE compiled program serves every variable
            tang = {}
            for e, layer in inputs:
                m = layer.mean_state(st).astype(dt)  # (F, K)
                sel = (jnp.asarray(layer.scope_idx[:, 0]) == uu).astype(dt)[:, None]
                tang[f"__r{e}"] = jnp.broadcast_to(
                    (m * sel)[:, None, :], offs[f"__r{e}"].shape
                )
            _, hvp = jax.jvp(grad_fn, (offs,), (tang,))
            return contract(hvp, lambda l: l.mean_state(st))

        if mode in ("marginals", "mi_row"):
            out = jnp.zeros((bsz, num_vars, supp), dt)
            for e, layer in inputs:
                r = resp[f"__r{e}"]  # (F, B, K)
                dist = layer.state_distribution(st).astype(dt)  # (F, K, s)
                pm = jnp.einsum("fbk,fks->fbs", r, dist, precision=hp)
                if pm.shape[2] < supp:
                    pm = jnp.pad(pm, ((0, 0), (0, 0), (0, supp - pm.shape[2])))
                onehot = jax.nn.one_hot(layer.scope_idx[:, 0], num_vars, dtype=dt)
                out = out + jnp.einsum("fbs,fd->bds", pm, onehot, precision=hp)
            obs = jax.nn.one_hot(
                jnp.clip(xx.astype(jnp.int32), 0, supp - 1), supp, dtype=dt
            )
            res = jnp.where(mk[:, :, None], obs, out)
            if mode == "mi_row":
                # fused anchor-row reduce (the _mi_row_reduce math): anchor
                # states with p(s) = 0 — impossible evidence OR support
                # padding rows beyond this anchor's true state count — are
                # masked out after nan_to_num, so they contribute nothing
                marg_f = marg_t.astype(dt)
                p_u = jnp.einsum("d,ds->s", colb.astype(dt), marg_f)
                lcond = jnp.where(res > 0, jnp.log(res), 0.0)
                lmarg = jnp.where(marg_f > 0, jnp.log(marg_f), 0.0)
                kl = jnp.sum(res * (lcond - lmarg[None]), axis=2)  # (S, D)
                kl = jnp.where((p_u > 0)[:, None], jnp.nan_to_num(kl), 0.0)
                return jnp.einsum("s,sd->d", p_u, kl)
            # the cast fuses into the producing ops: the materialized
            # (B, D, S) table is written at the reduced width
            return res if out_dtype is None else res.astype(out_dtype)

        if mode == "cdf":
            tt = uu  # thresholds (B, D), the dispatch's extra argument
            obs = (xx.astype(dt) <= tt).astype(dt)
            return jnp.where(mk, obs, cdf_at(tt))

        if mode == "quantile":
            qq = uu  # target probabilities (B, D)
            m1 = weighted(lambda l: l.mean_state(st))
            m2 = weighted(lambda l: l.second_moment_state(st))
            sd = jnp.sqrt(jnp.maximum(m2 - jnp.square(m1), 0.0))
            # bracket the generalized inverse around the posterior mean:
            # start at +-(4 sd + 1) and double where the target q is still
            # outside — 12 doublings cover ~16000 posterior sds, far past
            # any Chebyshev tail bound a practical q needs
            def expand(_, c):
                out = (cdf_at(m1 - c) > qq) | (cdf_at(m1 + c) < qq)
                return jnp.where(out, 2.0 * c, c)

            c = jax.lax.fori_loop(0, 12, expand, 4.0 * sd + 1.0)

            def bisect(_, lh):
                lo, hi = lh
                mid = 0.5 * (lo + hi)
                below = cdf_at(mid) < qq
                return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

            lo, hi = jax.lax.fori_loop(0, 60, bisect, (m1 - c, m1 + c))
            # hi converges from above: the generalized inverse
            # inf{t : F(t) >= q}, landing ON the jump for step CDFs
            return jnp.where(mk, xx.astype(dt), hi)

        m1 = weighted(lambda l: l.mean_state(st))
        mean = jnp.where(mk, xx.astype(dt), m1)
        if mode == "mean":
            return mean
        m2 = weighted(lambda l: l.second_moment_state(st))
        # law of total variance over the leaf units; clamp the tiny
        # negative residuals f32 cancellation can leave
        var = jnp.maximum(m2 - jnp.square(m1), 0.0)
        return mean, jnp.where(mk, jnp.zeros((), dt), var)

    return _run


def _variable_supports(cc: JaxCircuit) -> np.ndarray:
    """Per-variable finite support sizes (D,): -1 for variables covered by
    a continuous leaf, -2 for variables with no input layer at all (a
    non-contiguous circuit scope)."""
    from cirkit_tpu.backend.jax.layers import JaxConstantInputLayer

    num_vars = max(cc.scope) + 1
    supports = np.full(num_vars, -2, dtype=np.int64)
    for entry in cc._entries:
        layer = entry.layer
        if not isinstance(layer, JaxInputLayer) or isinstance(
            layer, JaxConstantInputLayer
        ):
            continue
        s = _leaf_support_size(layer)
        for v in np.asarray(layer.scope_idx[:, 0]):
            if s is None:
                supports[int(v)] = max(supports[int(v)], -1)
            else:
                supports[int(v)] = max(supports[int(v)], s)
    return supports


def mutual_information(
    circuit: JaxCircuit,
    *,
    store: Store | None = None,
    variables: Sequence[int] | None = None,
    x: jnp.ndarray | np.ndarray | None = None,
    evidence_mask: jnp.ndarray | np.ndarray | None = None,
    output: int = 0,
    unit: int = 0,
) -> jnp.ndarray:
    """Exact pairwise mutual information under the circuit distribution:
    a (k, k) matrix over ``variables`` (default: every variable) with
    ``out[i, j] = I(x_ui ; x_uj)`` in nats and the marginal entropies
    ``H(x_ui)`` on the diagonal. With ``x``/``evidence_mask`` (a single
    assignment), every term conditions on the evidence —
    ``I(x_ui ; x_uj | x_obs)`` — and rows/columns of observed variables
    are exactly 0. An extension beyond the reference (whose only queries
    are integration and sampling, ref ``backend/torch/queries.py:19-275``):
    this is the dependence signal Chow-Liu structure learning estimates
    from *data* (ref ``utils/algorithms.py``-style MI estimators), computed
    exactly from the *model* — see ``models.region_graph.chow_liu_tree``
    for the data-side counterpart.

    Mechanism: one batched :meth:`ExpectationQuery.marginals` call per
    anchor variable u — the batch enumerates u's states as evidence, so a
    single backward pass yields ``p(x_v = t | x_u = s)`` for ALL v, t at
    once — combined with the unconditional marginals via
    ``I(u, v) = sum_s p(s) KL(p(x_v | x_u = s) || p(x_v))``. Everything
    reduces on-device; cost is linear in ``len(variables)`` (each call has
    batch = u's support size), so query the subset you need on large
    circuits. Requires finite-support leaves at the queried variables.
    Unnormalized circuits are fine: responsibilities self-normalize.
    """
    q = ExpectationQuery(circuit)
    supports = _variable_supports(circuit)
    num_vars = supports.shape[0]
    if variables is None:
        variables = [v for v in range(num_vars) if supports[v] != -2]
    variables = tuple(int(v) for v in variables)
    for v in variables:
        if not 0 <= v < num_vars or supports[v] == -2:
            raise ValueError(f"Variable {v} is outside the circuit scope")
        if supports[v] == -1:
            raise NotImplementedError(
                f"Mutual information needs finite-support leaves; variable "
                f"{v} has a continuous input layer"
            )
    if x is None:
        x0 = np.zeros(num_vars, dtype=np.int32)
        m0 = np.zeros(num_vars, dtype=bool)
    else:
        x0 = np.asarray(x, dtype=np.int32).reshape(num_vars)
        if evidence_mask is None:
            raise ValueError("Passing x requires evidence_mask")
        m0 = np.asarray(evidence_mask, dtype=bool).reshape(num_vars)

    marg = q.marginals(
        jnp.asarray(x0[None]), evidence_mask=jnp.asarray(m0[None]),
        store=store, output=output, unit=unit,
    )[0]  # (D, S)

    dt = jnp.result_type(float)
    # One fused program serves EVERY anchor: the anchor index is a runtime
    # scalar, the (S, D) anchor-state evidence is built on device, and the
    # KL row-reduce runs in the same program — per-anchor host->device
    # traffic drops from ~S*D ints (an evidence upload) to a few bytes, and
    # only the (D,) rows come back (pulled asynchronously below).
    rows = []
    for u in variables:
        if m0[u]:
            rows.append(np.zeros(num_vars))  # host: no device program
            continue
        rows.append(
            q._dispatch(
                "mi_row", x0[None], m0[None], store, output, unit,
                extra=(jnp.int32(u), marg),
            )
        )
    # Column-select and mask on HOST: a static-index gather on device is a
    # distinct program per `variables` tuple — a compile each (same scale
    # trap as per-anchor device slicing above). The rows are tiny (k x D) f32 pulls — issued
    # asynchronously first, so k transfers overlap into ~one round trip
    # instead of k sequential ones (at 784 anchors that is seconds).
    for r in rows:
        if hasattr(r, "copy_to_host_async"):
            r.copy_to_host_async()
    cols = np.asarray(variables)
    mat = np.stack([np.asarray(r, dtype=np.float64) for r in rows])[:, cols]
    mat[:, m0[cols]] = 0.0  # observed columns: conditioning makes them constants
    return jnp.asarray(mat, dt)


def _pad_samples(samples: jnp.ndarray, scope_idx: np.ndarray, num_vars: int) -> jnp.ndarray:
    """Scatter univariate per-unit samples (F, K, N) into zero-padded
    assignments (F, K, N, D) at the layer's variable positions."""
    if scope_idx.shape[1] != 1:
        raise NotImplementedError("Padding is only implemented for univariate samples")
    one_hot = jax.nn.one_hot(scope_idx[:, 0], num_vars, dtype=samples.dtype)  # (F, D)
    return samples[:, :, :, None] * one_hot[:, None, None, :]


class MAPQuery(Query):
    """Max-product MPE (most-probable-explanation) through the evaluation
    plan — an extension beyond the reference, whose only queries are
    integration and sampling (ref: ``backend/torch/queries.py:19-275``).

    Sum-style layers take the *max* over their mixture inputs instead of
    the sum and route the argmax child's assignment upward; input layers
    contribute their per-unit mode. With evidence, observed variables
    contribute their data log-likelihood instead, so the query completes
    partial assignments: ``argmax_{x_miss} p(x_miss, x_obs)`` per sample
    (image inpainting, classification under missing features, ...). The
    evidence mask is a runtime argument — one jitted program serves every
    query, like :class:`IntegrateQuery`.

    Exact on deterministic (selective) circuits; otherwise the standard
    max-product approximation, where the returned log-value is the weight
    of the best latent parse — a lower bound on the returned assignment's
    true log-probability. Requires normalized non-negative sum weights
    (the latent-variable semantics :class:`SamplingQuery` also assumes)
    and a circuit compiled under the ``lse-sum`` semiring.

    Root contract: the assignment maximizes ONE root output unit — flat
    output ``output``, unit ``unit`` (defaults (0, 0)) — and the returned
    ``log_values`` is that unit's max-product value. On circuits with
    several root units (e.g. one head per class) pass the target head;
    each (output, unit) pair compiles its own cached program.
    """

    def __init__(
        self,
        circuit: JaxCircuit,
        *,
        mesh=None,
        model_axis: str = "model",
        data_axis: str | None = "data",
    ) -> None:
        from cirkit_tpu.backend.jax.semiring import LSESumSemiring

        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                f"The circuit to maximize must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        if circuit.semiring is not LSESumSemiring:
            raise ValueError(
                "MAPQuery requires a circuit compiled under the 'lse-sum' "
                f"semiring, found {circuit.semiring.__name__}"
            )
        self._circuit = circuit
        # mesh: run the routing manually partitioned (shard_map) — weight
        # slots sharded per tp_slot_specs stay local to their shard, so the
        # contractions run on local shapes (TPRouting); pass a store
        # placed by shard_store_tp (a replicated store also works: shard_map
        # reshards it to the slot specs)
        self._mesh = mesh
        self._model_axis = model_axis
        self._data_axis = data_axis

    def __call__(
        self,
        x: jnp.ndarray | np.ndarray | None = None,
        *,
        evidence_mask: jnp.ndarray | np.ndarray | None = None,
        marginalize_vars: jnp.ndarray | np.ndarray | Scope | Sequence[Scope] | None = None,
        store: Store | None = None,
        output: int = 0,
        unit: int = 0,
        top_k: int | None = None,
        pad_batch_to: int | None = None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Compute MPE states: returns ``(assignments (B, D), log_values
        (B,))``. Unconditional when ``x`` is None (B=1); otherwise
        ``evidence_mask`` — a (B, D)/(D,) boolean mask, a Scope, or a
        sequence of Scopes (like IntegrateQuery) — marks the *observed*
        entries of ``x`` and free variables are maximized per sample.
        ``output``/``unit`` select the root head being maximized.

        ``marginalize_vars`` (same spec forms; runtime data — one jitted
        program serves every split) makes this a **marginal MAP** query:
        marginalized variables are summed out at their input layers while
        the remaining free variables are maximized —
        ``argmax_{x_max} sum_{x_marg} p(x_max, x_marg, x_obs)`` under the
        circuit's max-product relaxation (exact when the maximized
        variables' layers sit above the summed ones, the classic MMAP
        tractability condition; a bound otherwise, like plain MPE on
        non-selective circuits). Marginalized entries of the returned
        assignment are 0. The reference cannot express this query at all
        (and compiling an integrated circuit first does not help: its
        constant layers have no MPE states).

        ``top_k=T`` returns the T best parses instead: ``(assignments
        (B, T, D), log_values (B, T))``, scores descending — the k-best
        semiring through the plan (:mod:`cirkit_tpu.backend.jax.topk`).
        Exact top-T assignments on deterministic circuits; k best latent
        parses otherwise (distinct parses may repeat an assignment).
        Slots beyond the number of existing parses carry ``-inf`` scores.
        Moderate-scale XLA path; not combinable with ``marginalize_vars``.
        """
        cc = self._circuit
        num_vars = max(cc.scope) + 1
        if x is None:
            if evidence_mask is not None:
                raise ValueError("evidence_mask requires an input batch x")
            x = jnp.zeros((1, num_vars))
            mask = jnp.zeros((1, num_vars), dtype=bool)
            _b = None
        else:
            if evidence_mask is None:
                raise ValueError(
                    "Pass evidence_mask marking the observed entries of x "
                    "(an all-False mask reproduces the unconditional query)"
                )
            x, evidence_mask, marginalize_vars, _b = _pad_rows(
                pad_batch_to, x, evidence_mask, marginalize_vars
            )
            x = jnp.asarray(x)
            mask = _evidence_to_mask(cc, evidence_mask, x.shape[0])
        # mg stays None on the plain-MAP path: the traced program then
        # contains no marginalization ops at all, and the overlap check
        # (a host numpy check — no eager device programs, per CLAUDE.md's
        # no-data-dependent-Python rule for evaluation paths) only runs
        # when a marginal-MAP split is actually requested
        mg = None
        if marginalize_vars is not None:
            mg = _evidence_to_mask(cc, marginalize_vars, x.shape[0])
            if (np.asarray(mask) & np.asarray(mg)).any():
                raise ValueError(
                    "A variable cannot be both observed (evidence_mask) and "
                    "marginalized (marginalize_vars)"
                )
        if store is None:
            store = getattr(cc, "default_store", None)
            if store is None:
                raise ValueError("No parameter store bound; pass store=...")
        store = cc.restrict_store(store)

        if top_k is not None:
            if top_k < 1:
                raise ValueError(f"top_k must be >= 1, found {top_k}")
            if mg is not None:
                raise NotImplementedError(
                    "top_k cannot be combined with marginalize_vars"
                )
            if self._mesh is not None:
                raise NotImplementedError(
                    "top_k is not supported on a tensor-parallel mesh"
                )
            fn = _topk_jit(cc, top_k, output, unit)
            return _slice_rows(fn(store, x, mask), _b)  # (B, T, D), (B, T)

        fn = _routing_jit(
            cc, "max", output, unit,
            mesh=self._mesh, model_axis=self._model_axis, data_axis=self._data_axis,
        )
        asg, vals, _ = fn(store, x, mask, mg)  # (B, D), (O, B, K)
        return _slice_rows((asg, vals[output, :, unit]), _b)


def _evidence_to_mask(cc: JaxCircuit, evidence_mask, batch: int) -> jnp.ndarray:
    """Normalize an evidence specification — boolean array (B, D)/(D,), a
    Scope, or a sequence of Scopes of length 1 or B — to a (B, D) mask."""
    if isinstance(evidence_mask, (jnp.ndarray, np.ndarray)):
        mask = jnp.asarray(evidence_mask)
        if mask.dtype != jnp.bool_:
            raise ValueError(f"Expected a boolean mask, found dtype {mask.dtype}")
        if mask.ndim == 1:
            mask = jnp.broadcast_to(mask[None], (batch, mask.shape[0]))
    else:
        mask = jnp.asarray(IntegrateQuery.scopes_to_mask(cc, evidence_mask))
    if mask.shape[0] == 1 and batch != 1:
        mask = jnp.broadcast_to(mask, (batch, mask.shape[1]))
    if mask.shape[0] != batch:
        raise ValueError(
            f"The evidence mask covers {mask.shape[0]} samples, expected {batch}"
        )
    return mask


def _routing_jit(
    cc: JaxCircuit,
    kind: str,
    root_output: int,
    root_unit: int,
    mesh=None,
    model_axis: str = "model",
    data_axis: str | None = "data",
):
    """The jit-compiled routing program for one (kind, root) choice, cached
    on the circuit (fresh query objects never retrace). With ``mesh`` the
    program is manually partitioned over the mesh's ``model_axis`` via
    ``shard_map`` (see :class:`TPRouting`): unit-sharded weight slots stay
    local to their shard — including inside the contractions — and
    the batch additionally shards over ``data_axis`` when it divides."""
    cache = getattr(cc, "_routing_jits", None)
    if cache is None:
        cache = cc._routing_jits = {}
    key = (kind, root_output, root_unit, mesh, model_axis, data_axis)
    if key not in cache:
        if mesh is None:
            from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

            cache[key] = CachedJit(
                _build_routing_run(cc, kind, root_output=root_output, root_unit=root_unit),
                name="routing",
                key_parts=(circuit_fingerprint(cc), kind, root_output, root_unit),
            )
        else:
            cache[key] = _tp_routing_jit(
                cc, kind, root_output, root_unit, mesh, model_axis, data_axis
            )
    return cache[key]


def _tp_routing_jit(
    cc: JaxCircuit,
    kind: str,
    root_output: int,
    root_unit: int,
    mesh,
    model_axis: str,
    data_axis: str | None,
):
    """shard_map wrapper around the TP-aware routing program: weight slots
    listed by :func:`cirkit_tpu.parallel.tensor.tp_slot_specs` arrive as
    local unit shards (so the contractions run on local shapes), everything
    else is replicated; collectives inside the
    program combine the per-shard results (:class:`TPRouting`)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cirkit_tpu.parallel.tensor import tp_routing_descriptor

    tpd, slot_ps = tp_routing_descriptor(cc, mesh, model_axis=model_axis)
    run = _build_routing_run(
        cc, kind, root_output=root_output, root_unit=root_unit, tp=tpd
    )
    dsz = mesh.shape.get(data_axis, 1) if data_axis else 1

    def fn(st, xx, mk, mg=None, key=None):
        # batch-shard only the deterministic (max) pass: the sample pass's
        # categorical/Gumbel draws take noise shaped like the LOCAL batch,
        # so a data-sharded draw would not be the single-device draw (each
        # data shard would reuse shard 0's noise positions)
        use_data = kind == "max" and dsz > 1 and xx.shape[0] % dsz == 0
        bspec = P(data_axis) if use_data else P()
        fbspec = P(None, data_axis) if use_data else P()
        in_specs = [
            {s: slot_ps.get(s, P()) for s in st},
            bspec,
            bspec,
        ]
        extra = []
        if mg is not None:
            in_specs.append(bspec)
            extra.append(mg)
        if key is not None:
            in_specs.append(P())
            extra.append(key)
        has_mg, has_key = mg is not None, key is not None

        def body(st_, xx_, mk_, *ex):
            mg_ = ex[0] if has_mg else None
            key_ = ex[-1] if has_key else None
            return run(st_, xx_, mk_, mg_, key_)

        mapped = shard_map(
            body,
            mesh=mesh,
            in_specs=tuple(in_specs),
            # (asg (B, D), root_vals (O, B, K), mixtures: tuple of (F, B))
            out_specs=(bspec, fbspec, fbspec),
            check_vma=False,
        )
        return mapped(dict(st), xx, mk, *extra)

    return jax.jit(fn)


def _topk_jit(cc: JaxCircuit, topk: int, root_output: int, root_unit: int):
    """The jit-compiled top-k MPE program for one (T, root) choice, cached
    on the circuit like the 1-best routing programs."""
    from cirkit_tpu.backend.jax.topk import build_topk_run

    cache = getattr(cc, "_routing_jits", None)
    if cache is None:
        cache = cc._routing_jits = {}
    key = ("topk", topk, root_output, root_unit)
    if key not in cache:
        from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

        cache[key] = CachedJit(
            build_topk_run(cc, topk, root_output=root_output, root_unit=root_unit),
            name="topk", key_parts=(circuit_fingerprint(cc), topk, root_output, root_unit),
        )
    return cache[key]


class TPRouting(NamedTuple):
    """Static tensor-parallel descriptor for the routing passes: the model
    mesh-axis name, its size, and a per-plan-entry flag marking entries
    whose own parameters are unit-sharded over that axis (built by
    :func:`cirkit_tpu.parallel.tensor.tp_routing_descriptor`). With it,
    :func:`_build_routing_run` emits a *manually partitioned* program meant
    to run under ``shard_map``: every layer contraction and routing pass
    sees only its local weight shard, and the cross-shard combination is an
    explicit collective (``all_gather`` of the small activations upward,
    masked ``psum``/``pmax`` of the per-shard selections downward), so no
    weight is ever gathered whole."""

    axis: str
    size: int
    entry_sharded: tuple[bool, ...]


def _max_weight(param, st) -> jnp.ndarray:
    """Evaluate a sum-layer weight plan under MAX-product semantics.

    The sum-collapse fusion (optimization.py::apply_sum_collapse) replaces
    two stacked dense sums with one whose weight is ``MatMul(W1, W2)`` — a
    SUM over the fused inner sum's latent units. That contraction is sound
    for the (+, *) forward (and for sampling: marginalizing the latent
    preserves the conditional over the composite input), but NOT for the
    tropical (max, *) carrier: MPE maxes over every latent, so the composite
    weight must be ``max_j W2[o, j] * W1[j, i]`` — a tropical matrix product
    of the factors. The latent ``j`` is internal to the weight (the inner
    sum's children ARE the collapsed layer's inputs), so the downward
    routing needs no extra stage: the argmax over the composite input index
    under this weight is exactly the two-stage MPE choice. Every other
    parameter node in a weight plan is elementwise/layout-only over the
    unit axes, so the plain evaluation is reused for them — but only while
    nothing sits BETWEEN a MatMul and the plan output except further
    MatMuls: a node applied to the maxed composite (e.g. a user rule
    emitting ``Softmax(MatMul(...))``) would see different values than the
    forward's summed composite and silently break max/forward consistency,
    so that shape raises (mirroring ``topk._parse_weight``)."""

    def tropical_matmul(plan, node, ins):
        if not isinstance(node, JaxMatMulParameter):
            return None
        for user in plan.node_outputs(node):
            if not isinstance(user, JaxMatMulParameter):
                raise NotImplementedError(
                    "MAP/MPE through a fused weight graph where a "
                    f"MatMul feeds {type(user).__name__} is not supported"
                )
        w1, w2 = ins  # (F, j, i) inner, (F, o, j) outer
        return jnp.max(w2[:, :, :, None] * w1[:, None, :, :], axis=2)

    return param(st, node_override=tropical_matmul)


def _build_routing_run(
    cc: JaxCircuit,
    kind: str,
    *,
    root_output: int = 0,
    root_unit: int = 0,
    tp: TPRouting | None = None,
):
    """The shared two-pass routing behind :class:`MAPQuery` (``kind="max"``)
    and conditional sampling (``kind="sample"``).

    **Upward pass** over the evaluation plan: every layer produces log-space
    values (F, B, K) — observed variables contribute their data likelihood,
    free variables their mode (``max``) or marginal (``sample``). For
    ``sample`` this is exactly the circuit's own (masked-integrate) forward,
    so every inner layer runs its regular ``forward``; for ``max`` the
    sum-style layers take the
    max over their mixture scores instead (a tropical forward). Nothing is
    drawn or argmaxed on the way up.

    **Downward pass** over the reversed plan: decomposability guarantees a
    parse activates each (entry, fold, sample) at most once, so the entire
    selection state is ONE unit index per (fold, sample) (-1 = inactive),
    combined across DAG consumers by elementwise max. At each sum-style
    entry the routing choice is made **lazily, only at the selected output
    unit**: the chosen unit's weight row is extracted with a one-hot
    matmul (a contraction, not a gather), the mixture scores
    ``log w[o*, m] + comb[m]`` are recomputed from the child values, and a
    single argmax (``max``) or Gumbel/categorical draw (``sample``) over
    the composite axis picks the route. This is standard top-down ancestral
    sampling of the latent parse and cuts the per-entry choice work from
    (F, O, M, B) to (F, M, B) — on the MNIST flagship it reduces the
    sampled-noise volume by the unit count O=64 (52G -> 0.8G perturbed
    scores per batch). The chosen index decomposes per operand with
    integer arithmetic only and pushes through the plan's static fold
    gathers; the output assignment gathers the selected input layers'
    per-unit states and scatters them at their scopes.

    The memory high-water mark is a few activation-sized arrays per layer.
    The earlier one-pass design carried zero-padded (F, K, B, D) assignment
    tensors upward, which is quadratic in the number of variables — 20 GB
    at the MNIST flagship's input layer (784 folds x 64 units x batch 128 x
    784 variables) and an OOM on a 16 GB chip.
    """
    from cirkit_tpu.backend.jax.layers import (
        JaxConstantInputLayer,
        JaxHadamardLayer,
        JaxKroneckerLayer,
        JaxSumLayer,
    )
    from cirkit_tpu.backend.jax.optimized import (
        JaxCPTLayer,
        JaxTensorDotLayer,
        JaxTuckerLayer,
    )
    from cirkit_tpu.backend.jax.utils import safelog

    num_vars = max(cc.scope) + 1
    name = "MAP" if kind == "max" else "Conditional sampling"
    entries = cc._entries
    sum_style = (JaxSumLayer, JaxCPTLayer, JaxTuckerLayer, JaxTensorDotLayer)

    def _run(st, xx, mk, mg=None, key=None):
        bsz = xx.shape[0]
        if tp is not None:
            # manual tensor parallelism (under shard_map): st holds LOCAL
            # unit shards for the flagged entries' slots; activations are
            # gathered back to full width right after each sharded layer
            # (the shard-the-weights / gather-the-activations recipe of
            # tp_forward), so everything downstream keeps full-width
            # semantics and the only other TP touch points are the
            # downward passes' per-shard selection combines
            def _tpg(a, full=None):
                # some layer hooks build constants from static metadata
                # (e.g. a probs-categorical's integrate is a zeros(F, K) of
                # the FULL unit count) rather than from the local store
                # shard — gather only arrays that are actually local-width
                if full is not None and a.shape[-1] == full:
                    return a
                return jax.lax.all_gather(a, tp.axis, axis=-1, tiled=True)

            tp_rank = jax.lax.axis_index(tp.axis)
        if key is not None:
            # draw under the rbg PRNG: the categorical draws' random bits
            # are pure HBM traffic (XLA materializes them), and rbg bits
            # cost ~2.6x less than threefry at this volume (docs/PERF.md)
            kd = jax.random.key_data(key)
            if kd.shape[-1] == 2:  # threefry/legacy 2-word keys
                key = jax.random.wrap_key_data(jnp.tile(kd, 2), impl="rbg")
            elif kd.shape[-1] == 4:  # already rbg-width
                key = jax.random.wrap_key_data(kd, impl="rbg")
            # other widths: keep the caller's key/impl unchanged
            # keys[e]: downward routing draw of entry e; keys[nk + e]: the
            # assembly's lazy input-state draw of entry e
            all_keys = jax.random.split(key, 2 * len(entries))
        else:
            all_keys = None

        def _gather_in(entry, vals):
            """The entry's (F, H, B, K) child-value block via the plan's
            static fold gather (mirrors ``JaxCircuit.evaluate_raw``)."""
            cat = (
                vals[entry.in_ids[0]]
                if len(entry.in_ids) == 1
                else jnp.concatenate([vals[i] for i in entry.in_ids], axis=0)
            )
            return cat[:, None] if entry.fold_idx is None else cat[entry.fold_idx]

        # ---- upward pass: values (F, B, K), no draws ------------------------
        vals: list[jnp.ndarray] = []
        recs: list = []
        for e_i, entry in enumerate(entries):
            layer = entry.layer
            e_sh = tp is not None and tp.entry_sharded[e_i]
            if isinstance(layer, JaxConstantInputLayer):
                raise NotImplementedError(
                    f"{name} is not supported for {type(layer).__name__}"
                )
            if isinstance(layer, JaxInputLayer):
                if layer.num_variables != 1:
                    raise NotImplementedError(
                        f"{name} of multivariate input layers is not supported"
                    )
                si = layer.scope_idx
                sh = e_sh
                xin = jnp.transpose(xx[:, si], (1, 0, 2))  # (F, B, 1)
                ku = layer.num_output_units
                obs_val = layer(st, xin)  # (F, B, K) — K/n local under TP
                if sh:
                    obs_val = _tpg(obs_val, ku)
                mgrow = None
                if kind == "max":
                    free_val, free_arg = layer.mpe(st)  # (F, K)
                    if sh:
                        free_val = _tpg(free_val, ku)
                        free_arg = _tpg(free_arg, ku)
                    fv = free_val[:, None, :]
                    if mg is not None:
                        # marginal MAP: summed-out variables contribute
                        # their integral instead of their mode
                        mgrow = jnp.transpose(mg[:, si[:, 0]], (1, 0))  # (F, B)
                        iv = layer.integrate(st)
                        fv = jnp.where(
                            mgrow[:, :, None],
                            (_tpg(iv, ku) if sh else iv)[:, None, :],
                            fv,
                        )
                else:
                    iv = layer.integrate(st)
                    fv = (_tpg(iv, ku) if sh else iv)[:, None, :]  # (F, 1, K)
                    free_arg = None  # states are drawn lazily at assembly
                xi = xin[..., 0].astype(obs_val.dtype)  # (F, B)
                mrow = jnp.transpose(mk[:, si[:, 0]], (1, 0))  # (F, B)
                vals.append(jnp.where(mrow[:, :, None], obs_val, fv))
                recs.append(("input", xi, mrow, free_arg, mgrow))
                continue

            v = _gather_in(entry, vals)  # (F, H, B, K)
            if kind == "max" and isinstance(layer, sum_style):
                # tropical forward: max over the mixture scores; the argmax
                # is NOT tracked here — the downward pass recomputes it at
                # the single selected unit per (fold, sample)
                w = _max_weight(layer.weight, st)
                if isinstance(layer, JaxTuckerLayer):
                    comb = _tucker_comb(v)  # (F, B, M)
                elif isinstance(layer, JaxCPTLayer):
                    comb = v.sum(axis=1)
                elif isinstance(layer, JaxSumLayer):
                    f, h, b, k = v.shape
                    comb = jnp.transpose(v, (0, 2, 1, 3)).reshape(f, b, h * k)
                else:  # tensordot
                    f, _, b, m = v.shape
                    kk, kj = w.shape[1:]
                    kq = m // kj
                    vv = v[:, 0].reshape(f, b, kj, kq)
                    # out[q*Kk + k] = max_j w[k, j] . in[j, q]
                    s = safelog(w)[:, None, :, :, None] + vv[:, :, None, :, :]
                    val = jnp.max(s, axis=3)  # (F, B, Kk, Kq)
                    vals.append(jnp.transpose(val, (0, 1, 3, 2)).reshape(f, b, -1))
                    recs.append(("tensordot", kj, kq, kk))
                    continue
                scores = safelog(w)[:, None, :, :] + comb[:, :, None, :]
                tv = jnp.max(scores, axis=3)  # (F, B, O) — O/n local under TP
                vals.append(_tpg(tv, layer.num_output_units) if e_sh else tv)
            else:
                # the real forward; under TP the contraction runs on the
                # layer's local weight shard -> (F, B, O/n), gathered
                fv = layer(st, v)
                vals.append(_tpg(fv, layer.num_output_units) if e_sh else fv)
            if isinstance(layer, JaxHadamardLayer):
                recs.append(("hadamard",))
            elif isinstance(layer, JaxKroneckerLayer):
                recs.append(("kronecker", layer.arity, layer.num_input_units))
            elif isinstance(layer, JaxTuckerLayer):
                recs.append(("tucker", layer.arity, layer.num_input_units))
            elif isinstance(layer, JaxCPTLayer):
                recs.append(("cpt", layer.arity, layer.num_input_units))
            elif isinstance(layer, JaxSumLayer):
                recs.append(("sum", layer.arity, layer.num_input_units))
            elif isinstance(layer, JaxTensorDotLayer):
                kj = layer._num_contract_units
                kq = layer._num_batch_units
                recs.append(("tensordot", kj, kq, layer.num_output_units // kq))
            else:
                raise NotImplementedError(
                    f"{name} is not supported for {type(layer).__name__}"
                )

        # root values: (O, B, K)
        out_cat = (
            vals[cc._outputs.out_ids[0]]
            if len(cc._outputs.out_ids) == 1
            else jnp.concatenate([vals[i] for i in cc._outputs.out_ids], axis=0)
        )
        root_vals = out_cat if cc._outputs.fold_idx is None else out_cat[cc._outputs.fold_idx]

        # ---- downward pass: lazy selected-unit routing ----------------------
        neg = jnp.int32(-1)
        sels: list = [jnp.full((v.shape[0], bsz), neg, jnp.int32) for v in vals]
        if not 0 <= root_output < root_vals.shape[0]:
            raise ValueError(
                f"root output {root_output} out of range for a circuit with "
                f"{root_vals.shape[0]} outputs"
            )
        if not 0 <= root_unit < root_vals.shape[2]:
            raise ValueError(
                f"root unit {root_unit} out of range for {root_vals.shape[2]} "
                "output units"
            )
        root_entry = cc._outputs.out_ids[0]
        root_fold = root_output
        if len(cc._outputs.out_ids) > 1 or cc._outputs.fold_idx is not None:
            flat0 = (
                root_output
                if cc._outputs.fold_idx is None
                else int(cc._outputs.fold_idx[root_output])
            )
            off = 0
            for i in cc._outputs.out_ids:
                nf = vals[i].shape[0]
                if flat0 < off + nf:
                    root_entry, root_fold = i, flat0 - off
                    break
                off += nf
        sels[root_entry] = sels[root_entry].at[root_fold, :].set(root_unit)

        def _push_to_children(e, units_per_op):
            """Push per-operand (F, B) unit choices through entry e's static
            fold gather (constant indices) into the producers' selections."""
            entry = entries[e]
            units_per_op = [u.astype(jnp.int32) for u in units_per_op]
            if entry.fold_idx is None:
                sels[entry.in_ids[0]] = jnp.maximum(
                    sels[entry.in_ids[0]], units_per_op[0]
                )
                return
            total = sum(vals[i].shape[0] for i in entry.in_ids)
            cat = jnp.full((total, units_per_op[0].shape[1]), neg, jnp.int32)
            for h, u in enumerate(units_per_op):
                cat = cat.at[entry.fold_idx[:, h]].max(u)
            off = 0
            for i in entry.in_ids:
                nf = vals[i].shape[0]
                sels[i] = jnp.maximum(sels[i], cat[off : off + nf])
                off += nf

        draws: dict[int, jnp.ndarray] = {}

        def _choose_m(scores, active, lk):
            """argmax/draw over the last (composite) axis, only meaningful
            where ``active``; inactive rows are zeroed first so all-(-inf)
            score rows cannot poison the draw."""
            scores = jnp.where(active[..., None], scores, 0.0)
            if kind == "max":
                return jnp.argmax(scores, axis=-1)
            return jax.random.categorical(lk, scores, axis=-1)

        for e in range(len(entries) - 1, -1, -1):
            rec = recs[e]
            if rec[0] == "input":
                continue
            lk = all_keys[e] if all_keys is not None else None
            sel = sels[e]  # (F, B) unit index or -1
            active = sel >= 0
            safe = jnp.maximum(sel, 0)
            entry = entries[e]
            layer = entry.layer
            if rec[0] == "hadamard":
                _push_to_children(e, [sel] * layer.arity)
                continue
            if rec[0] == "kronecker":
                _, h, k = rec
                units = []
                rem = safe
                for hh in range(h - 1, -1, -1):
                    units.append(jnp.where(active, rem % k, neg))
                    rem = rem // k
                units.reverse()
                _push_to_children(e, units)
                continue

            # sum-style: recompute the mixture scores at the selected output
            # unit only, then argmax/draw once per (fold, sample). Max mode
            # must score with the same tropical composite weight the upward
            # pass used (a sum-collapsed MatMul weight maxes, not sums, over
            # the fused latent); sampling keeps the plain contraction — the
            # summed weight IS the marginalized draw distribution.
            v = _gather_in(entry, vals)  # (F, H, B, K)
            w = _max_weight(layer.weight, st) if kind == "max" else layer.weight(st)
            dt = v.dtype
            e_sh = tp is not None and tp.entry_sharded[e]
            if e_sh:
                # the selected output unit lives on exactly one shard: shift
                # the global unit index into this shard's local row space and
                # mask rows this shard does not own; the per-shard results
                # are combined with a psum/pmax below
                o_loc = w.shape[1]
                sel_loc = safe - (tp_rank * o_loc).astype(jnp.int32)
                inr = active & (sel_loc >= 0) & (sel_loc < o_loc)
                safe_loc = jnp.clip(sel_loc, 0, o_loc - 1)
            if rec[0] == "tensordot":
                _, kj, kq, kk = rec
                f, _, b, mtot = v.shape
                # output unit o = q*Kk + k: select the w row by k and the
                # in column by q, both via exact one-hot contractions
                q, kout = safe // kk, safe % kk
                # floor -inf child values at -1e30 before the one-hot
                # selection einsum: 0 * -inf = NaN would poison finite
                # columns, and |finfo.min| rounds to -inf under a TF32/bf16
                # operand conversion; HIGHEST keeps the selected values
                # exact
                hp = jax.lax.Precision.HIGHEST
                vv = jnp.maximum(v[:, 0].reshape(f, b, kj, kq), jnp.asarray(-1e30, dt))
                oh_k = jax.nn.one_hot(kout, kk, dtype=dt) * active[..., None]
                oh_q = jax.nn.one_hot(q, kq, dtype=dt)
                selw = jnp.einsum("fbk,fkj->fbj", oh_k, w, precision=hp)
                selv = jnp.einsum("fbjq,fbq->fbj", vv, oh_q, precision=hp)
                scores = safelog(selw) + selv
                j = _choose_m(scores, active, lk)
                draws[e] = jnp.where(active, j, neg)
                _push_to_children(e, [jnp.where(active, j * kq + q, neg)])
                continue

            tag, h, k = rec
            hp = jax.lax.Precision.HIGHEST
            if e_sh:
                oh = jax.nn.one_hot(safe_loc, w.shape[1], dtype=dt)
                oh = oh * inr[..., None]  # (F, B, O/n), owner rows only
            else:
                oh = jax.nn.one_hot(safe, layer.num_output_units, dtype=dt)
                oh = oh * active[..., None]  # (F, B, O)
            # HIGHEST: a TF32/bf16 pass would round the selected weights
            # (and could turn a huge value into -inf, then NaN via 0 * -inf)
            selw = jnp.einsum("fbo,fom->fbm", oh, w, precision=hp)  # (F, B, M)
            if e_sh:
                # non-owners contributed all-zero rows; the sum recovers the
                # owner's exact weight row on every shard (x + 0 == x)
                selw = jax.lax.psum(selw, tp.axis)
            if tag == "tucker":
                comb = _tucker_comb(v)  # (F, B, K^H)
            elif tag == "cpt":
                comb = v.sum(axis=1)  # (F, B, K)
            else:  # sum
                f, hh_, b, k_ = v.shape
                comb = jnp.transpose(v, (0, 2, 1, 3)).reshape(f, b, hh_ * k_)
            m = _choose_m(safelog(selw) + comb, active, lk)
            draws[e] = jnp.where(active, m, neg)
            if tag == "sum":
                op, unit = m // k, m % k
                units = [
                    jnp.where(active & (op == hh), unit, neg) for hh in range(h)
                ]
            elif tag == "cpt":
                units = [jnp.where(active, m, neg)] * h
            else:  # tucker: composite row-major over arity digits
                units = []
                rem = m
                for hh in range(h - 1, -1, -1):
                    units.append(jnp.where(active, rem % k, neg))
                    rem = rem // k
                units.reverse()
            _push_to_children(e, units)

        # ---- assemble the assignment ---------------------------------------
        dtype = root_vals.dtype
        out_asg = jnp.zeros((bsz, num_vars), dtype)
        # mixtures: the composite routing index actually used at each sum-
        # style entry, (F, B) with -1 where the entry was not on the parse
        mixtures = [draws[e] for e in sorted(draws)]
        nk = len(entries)
        for e, rec in enumerate(recs):
            if rec[0] != "input":
                continue
            _, xi, mrow, free_arg, mgrow = rec
            sel = sels[e]  # (F, B)
            active = sel >= 0
            safe = jnp.maximum(sel, 0)
            layer = entries[e].layer
            # lazy state of the SELECTED unit only: the mode's argmax row
            # for MAP, one sample_selected draw for conditional sampling —
            # never the full (F, B, K) per-unit state block
            if kind == "max":
                free = jnp.take_along_axis(free_arg.astype(dtype), safe, axis=1)
                if mgrow is not None:
                    # marginalized variables have no MPE state: leave 0
                    free = jnp.where(mgrow, jnp.zeros((), dtype), free)
            elif tp is not None and tp.entry_sharded[e]:
                # the selected unit's parameters live on one shard: draw
                # there with the shifted local index and psum the masked
                # states (non-owners contribute exact zeros)
                k_loc = vals[e].shape[2] // tp.size
                sel_loc = safe - (tp_rank * k_loc).astype(jnp.int32)
                inr = active & (sel_loc >= 0) & (sel_loc < k_loc)
                fl = layer.sample_selected(
                    st, all_keys[nk + e], jnp.clip(sel_loc, 0, k_loc - 1)
                ).astype(dtype)
                free = jax.lax.psum(
                    jnp.where(inr, fl, jnp.zeros((), dtype)), tp.axis
                )
            else:
                free = layer.sample_selected(st, all_keys[nk + e], safe).astype(dtype)
            picked = jnp.where(mrow, xi, free)  # (F, B)
            w = jnp.where(active, picked, jnp.zeros((), dtype))
            onehot = jax.nn.one_hot(layer.scope_idx[:, 0], num_vars, dtype=dtype)
            # HIGHEST: the scatter must not round continuous states to bf16
            out_asg = out_asg + jnp.einsum(
                "fb,fd->bd", w, onehot, precision=jax.lax.Precision.HIGHEST
            )
        out_asg = jnp.where(mk, xx.astype(dtype), out_asg)
        return out_asg, root_vals, tuple(mixtures)

    return _run


def _tucker_comb(v: jnp.ndarray) -> jnp.ndarray:
    """The additive (log-space) Kronecker composite of a Tucker entry's
    child values: (F, H, B, K) -> (F, B, K^H), row-major over the arity
    digits (matching the Tucker core weight layout)."""
    f, h, b, k = v.shape
    comb = v[:, 0]
    for hh in range(1, h):
        comb = (comb[:, :, :, None] + v[:, hh][:, :, None, :]).reshape(f, b, -1)
    return comb
