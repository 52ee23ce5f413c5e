"""Exact Shannon entropy of (deterministic) circuit distributions.

An extension beyond the reference, whose query surface is integration and
sampling only (ref: ``cirkit/backend/torch/queries.py:19-275``). For a
smooth, decomposable, **deterministic** circuit (every sum's children have
disjoint supports — e.g. compiled logic/SDD circuits, decision-diagram
style models) the entropy of the normalized distribution computes exactly
in ONE bottom-up pass (Vergari et al., "A Compositional Atlas of Tractable
Circuit Operations", NeurIPS 2021):

- leaf unit: closed-form entropy of the normalized unit distribution;
- product: entropies add (children have disjoint scopes);
- deterministic sum: ``H_o = sum_m pi_m H_m - sum_m pi_m log pi_m`` with
  ``pi_m = w_om Z_m / Z_o`` the normalized mixture posterior.

On a NON-deterministic circuit the same recursion returns the joint
entropy of (latent parse, x) — ``H(x) + H(parse | x) >= H(x)`` — i.e. a
sound **upper bound** (exact entropy of non-deterministic circuits is
#P-hard). The docstrings and tests state both regimes.

The pass carries a per-unit ``(log Z, H)`` pair through the evaluation
plan in ``(F, B, K)`` layout; every mixture reduction is a guarded
exp-weighted matmul (no ``(F, B, O, M)`` score materialization), so the
conditional form scales to the flagship like IntegrateQuery does. With
evidence, observed leaves contribute ``(log p(x_v), 0)`` and the result is
the per-sample **posterior entropy** ``H(X_free | x_obs)`` — "how unsure
is the model about the rest" — sharing semantics with
:class:`cirkit_tpu.backend.jax.queries.ExpectationQuery`'s variances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.circuit import JaxCircuit
from cirkit_tpu.backend.jax.layers import (
    JaxConstantInputLayer,
    JaxHadamardLayer,
    JaxInputLayer,
    JaxKroneckerLayer,
    JaxSumLayer,
)
from cirkit_tpu.backend.jax.optimized import (
    JaxCPTLayer,
    JaxTensorDotLayer,
    JaxTuckerLayer,
)
from cirkit_tpu.backend.jax.parameters import Store
from cirkit_tpu.backend.jax.queries import Query, _evidence_to_mask, _tucker_comb
from cirkit_tpu.backend.jax.utils import safelog


class EntropyQuery(Query):
    """Shannon entropy (nats) of the circuit's normalized distribution.

    Exact on deterministic circuits; the latent upper bound
    ``H(x) + H(parse | x)`` otherwise (see the module docstring). With
    ``x``/``evidence_mask`` it returns per-sample posterior entropies
    ``H(X_free | x_obs)`` under the same evidence conventions as the other
    queries (True = observed; Scope specs accepted)."""

    def __init__(self, circuit: JaxCircuit) -> None:
        from cirkit_tpu.backend.jax.semiring import LSESumSemiring

        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                f"The circuit must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        if circuit.semiring is not LSESumSemiring:
            raise ValueError(
                "EntropyQuery requires a circuit compiled under the "
                f"'lse-sum' semiring, found {circuit.semiring.__name__}"
            )
        self._circuit = circuit

    def __call__(
        self,
        x: jnp.ndarray | np.ndarray | None = None,
        *,
        evidence_mask=None,
        store: Store | None = None,
        return_log_partition: bool = False,
    ):
        """Without ``x``: the (O, K) entropy of each root head. With
        ``x`` (B, D) and ``evidence_mask``: the (B, O, K) posterior
        entropy per sample. ``return_log_partition=True`` additionally
        returns the matching log-normalizer ``log Z`` (the evidence
        log-likelihood of the unnormalized measure), same shape."""
        cc = self._circuit
        num_vars = max(cc.scope) + 1
        unconditional = x is None
        if unconditional:
            if evidence_mask is not None:
                raise ValueError("evidence_mask requires x")
            x = jnp.zeros((1, num_vars), jnp.float32)
            mask = jnp.zeros((1, num_vars), bool)
        else:
            x = jnp.asarray(x)
            if evidence_mask is None:
                raise ValueError("x requires an evidence_mask")
            mask = _evidence_to_mask(cc, evidence_mask, x.shape[0])
            if mask.shape[1] != num_vars:
                raise ValueError(
                    f"The circuit scope has {num_vars} variables, but the "
                    f"mask covers {mask.shape[1]}"
                )
        if store is None:
            store = getattr(cc, "default_store", None)
            if store is None:
                raise ValueError("No parameter store bound; pass store=...")
        store = cc.restrict_store(store)
        fn = getattr(cc, "_entropy_jit", None)
        if fn is None:
            from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

            fn = cc._entropy_jit = CachedJit(
                _build_entropy_run(cc),
                name="entropy", key_parts=(circuit_fingerprint(cc),),
            )
        hh, lz = fn(store, x, mask)
        if unconditional:
            hh, lz = hh[0], lz[0]
        return (hh, lz) if return_log_partition else hh


def _mix(lz, hh, w):
    """One deterministic-sum reduction: composite ``(log Z_m, H_m)`` pairs
    (F, B, M) x weight rows (F, O, M) -> output pairs (F, B, O).

    ``log Z_o = lse_m(log w_om + lz_m)`` and
    ``H_o = sum_m pi_m H_m - sum_m pi_m log pi_m`` with
    ``log pi_m = log w_om + lz_m - log Z_o``. Every ``sum_m pi_m (...)``
    term is an exp-weighted matmul over M (HIGHEST precision) — the
    (F, B, O, M) score tensor is never materialized:
    ``sum_m pi_m log pi_m = (sum_m w~ e_m lz_m + sum_m (w~ log w~)_m e_m)
    / A_o - log A_o`` after the per-(f, b) max shift, where ``e = exp(lz -
    shift)`` and ``A_o = sum_m w_om e_m``."""
    hp = jax.lax.Precision.HIGHEST
    lw = safelog(w)
    shift = jnp.max(lz, axis=2, keepdims=True)
    shift = jnp.clip(shift, jnp.finfo(lz.dtype).min, jnp.finfo(lz.dtype).max)
    e = jnp.exp(lz - shift)  # (F, B, M), zeros where lz = -inf
    # guard every 0 * (-inf) product
    elz = jnp.where(e > 0, e * lz, 0.0)
    eh = e * hh
    wlw = jnp.where(w > 0, w * lw, 0.0)
    a = jnp.einsum("fbm,fom->fbo", e, w, precision=hp)  # Z_o / exp(shift)
    lzo = safelog(a) + shift  # (F, B, O)
    sh = jnp.einsum("fbm,fom->fbo", eh, w, precision=hp)
    slz = jnp.einsum("fbm,fom->fbo", elz, w, precision=hp)
    slw = jnp.einsum("fbm,fom->fbo", e, wlw, precision=hp)
    safe_a = jnp.maximum(a, jnp.finfo(a.dtype).tiny)
    # pi_m = w_om e_m / A_o, so  sum_m pi_m log pi_m
    #   = (slw + slz) / A - lzo   (log pi = log w + lz - lzo; sum pi = 1)
    # H_o = sh/A - [(slw + slz)/A - lzo] = (sh - slw - slz)/A + lzo
    ho = jnp.where(a > 0, (sh - slw - slz) / safe_a + lzo, 0.0)
    return lzo, ho


def _build_stat_run(cc: JaxCircuit, name: str, leaf_fn, mix_fn):
    """Generic bottom-up statistic pass over the evaluation plan.

    Statistics are TUPLES of (F, B, K) arrays per plan entry that (a) add
    componentwise across product children / composite digits (true for
    log-measures, entropies, and KL terms alike — disjoint scopes), and
    (b) reduce at sum-style entries via ``mix_fn``. ``leaf_fn(layer, st,
    xin, mrow)`` seeds input entries (``mrow`` True = observed);
    ``mix_fn(stats, layer, st)`` reduces composite stats (F, B, M) under
    the layer's weight rows. TensorDot entries are restructured into
    per-q dense mixes in the walker (stat-agnostic), so carriers only
    ever see plain (O, M) mixtures."""
    entries = cc._entries

    def _gather(entry, vals):
        cat = (
            vals[entry.in_ids[0]]
            if len(entry.in_ids) == 1
            else jnp.concatenate([vals[i] for i in entry.in_ids], axis=0)
        )
        return cat[:, None] if entry.fold_idx is None else cat[entry.fold_idx]

    def _run(st, xx, mk):
        stats: list[tuple[jnp.ndarray, ...]] = []
        for entry in entries:
            layer = entry.layer
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
                xin = jnp.transpose(xx[:, si], (1, 0, 2))  # (F, B, 1)
                mrow = jnp.transpose(mk[:, si[:, 0]], (1, 0))[:, :, None]  # (F, B, 1)
                stats.append(leaf_fn(layer, st, xin, mrow))
                continue

            g = tuple(_gather(entry, [s[i] for s in stats]) for i in range(len(stats[0])))
            if isinstance(layer, JaxHadamardLayer):
                stats.append(tuple(a.sum(axis=1) for a in g))
            elif isinstance(layer, JaxKroneckerLayer):
                stats.append(tuple(_tucker_comb(a) for a in g))
            elif isinstance(layer, JaxTuckerLayer):
                stats.append(mix_fn(tuple(_tucker_comb(a) for a in g), layer, st))
            elif isinstance(layer, JaxCPTLayer):
                stats.append(mix_fn(tuple(a.sum(axis=1) for a in g), layer, st))
            elif isinstance(layer, JaxSumLayer):
                f, h, b, k = g[0].shape
                flat = tuple(
                    jnp.transpose(a, (0, 2, 1, 3)).reshape(f, b, h * k) for a in g
                )
                stats.append(mix_fn(flat, layer, st))
            elif isinstance(layer, JaxTensorDotLayer):
                f, _, b, m = g[0].shape
                kj = layer._num_contract_units
                kq = m // kj
                # child composite index is j*Kq + q: per q-block the output
                # (q, kout) mixes over j with weight row w[kout, :]
                r = tuple(a[:, 0].reshape(f, b, kj, kq) for a in g)
                outs = [
                    mix_fn(tuple(a[:, :, :, q] for a in r), layer, st)
                    for q in range(kq)
                ]
                stats.append(
                    tuple(
                        jnp.stack([o[i] for o in outs], axis=2).reshape(f, b, -1)
                        for i in range(len(outs[0]))
                    )
                )
            else:
                raise NotImplementedError(
                    f"{name} is not supported for {type(layer).__name__}"
                )

        def _root(vals):
            cat = (
                vals[cc._outputs.out_ids[0]]
                if len(cc._outputs.out_ids) == 1
                else jnp.concatenate([vals[i] for i in cc._outputs.out_ids], axis=0)
            )
            if cc._outputs.fold_idx is not None:
                cat = cat[cc._outputs.fold_idx]
            return jnp.transpose(cat, (1, 0, 2))  # (O, B, K) -> (B, O, K)

        return tuple(_root([s[i] for s in stats]) for i in range(len(stats[0])))

    return _run


def _build_entropy_run(cc: JaxCircuit):
    def leaf(layer, st, xin, mrow):
        obs = layer(st, xin)  # (F, B, K) log-likelihoods
        lz = jnp.where(mrow, obs, layer.integrate(st)[:, None, :])
        hh = jnp.where(mrow, jnp.zeros_like(obs), layer.unit_entropy(st)[:, None, :])
        return lz, hh

    def mix(stats, layer, st):
        lz, hh = stats
        return _mix(lz, hh, layer.weight(st))

    run = _build_stat_run(cc, "EntropyQuery", leaf, mix)

    def _run(st, xx, mk):
        lz, hh = run(st, xx, mk)
        return hh, lz

    return _run


class KLDivergenceQuery(Query):
    """KL(p || q) between two parameterizations of the SAME compiled
    circuit (teacher-student distillation, EM-vs-SGD comparison, tracking
    drift across checkpoints) — one bottom-up pass, no sampling.

    Same exactness regime as :class:`EntropyQuery`: exact when the circuit
    is deterministic under ``store_p`` (sum children with disjoint
    supports — both parameterizations share the structural supports);
    otherwise it returns the KL between the joint (parse, x)
    distributions, which upper-bounds ``KL(p(x) || q(x))`` by the data
    -processing inequality. ``+inf`` is returned faithfully where q's
    support misses p's. With evidence it compares the two posteriors
    ``KL(p(X_free | x_obs) || q(X_free | x_obs))`` per sample."""

    def __init__(self, circuit: JaxCircuit) -> None:
        from cirkit_tpu.backend.jax.semiring import LSESumSemiring

        if not (circuit.properties.smooth and circuit.properties.decomposable):
            raise ValueError(
                f"The circuit must be smooth and decomposable, "
                f"but found {circuit.properties}"
            )
        if circuit.semiring is not LSESumSemiring:
            raise ValueError(
                "KLDivergenceQuery requires a circuit compiled under the "
                f"'lse-sum' semiring, found {circuit.semiring.__name__}"
            )
        self._circuit = circuit

    def __call__(
        self,
        store_p: Store,
        store_q: Store,
        x: jnp.ndarray | np.ndarray | None = None,
        *,
        evidence_mask=None,
    ):
        """Without ``x``: the (O, K) KL per root head. With ``x`` (B, D)
        and ``evidence_mask``: the (B, O, K) posterior KL per sample."""
        cc = self._circuit
        num_vars = max(cc.scope) + 1
        unconditional = x is None
        if unconditional:
            if evidence_mask is not None:
                raise ValueError("evidence_mask requires x")
            x = jnp.zeros((1, num_vars), jnp.float32)
            mask = jnp.zeros((1, num_vars), bool)
        else:
            x = jnp.asarray(x)
            if evidence_mask is None:
                raise ValueError("x requires an evidence_mask")
            mask = _evidence_to_mask(cc, evidence_mask, x.shape[0])
            if mask.shape[1] != num_vars:
                raise ValueError(
                    f"The circuit scope has {num_vars} variables, but the "
                    f"mask covers {mask.shape[1]}"
                )
        store_p = cc.restrict_store(store_p)
        store_q = cc.restrict_store(store_q)
        fn = getattr(cc, "_kl_jit", None)
        if fn is None:
            from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

            fn = cc._kl_jit = CachedJit(
                _build_kl_run(cc),
                name="kl", key_parts=(circuit_fingerprint(cc),),
            )
        kl = fn((store_p, store_q), x, mask)
        return kl[0] if unconditional else kl


def renyi2_entropy(
    cc: JaxCircuit,
    *,
    ctx,
    store: Store | None = None,
    x=None,
    evidence_mask=None,
):
    """Collision (Rényi order-2) entropy ``H_2 = -log sum_x p(x)^2`` of
    the normalized circuit distribution — **exact for any circuit the
    product operator supports** (smooth, structured-decomposable,
    compatible with itself), deterministic or not: it rides
    ``ctx.multiply(cc, cc)`` + integration, the compositional-atlas route,
    so it complements :class:`EntropyQuery` exactly where the Shannon
    recursion is only an upper bound. With ``x``/``evidence_mask`` it
    returns per-sample posterior collision entropies
    ``-log sum p(x_free | x_obs)^2``. Returns (O, K) without ``x``,
    (B, O, K) with; nats."""
    from cirkit_tpu.backend.jax.queries import IntegrateQuery

    num_vars = max(cc.scope) + 1
    unconditional = x is None
    if unconditional:
        if evidence_mask is not None:
            raise ValueError("evidence_mask requires x")
        x = jnp.zeros((1, num_vars), jnp.float32)
        mask = jnp.zeros((1, num_vars), bool)
    else:
        x = jnp.asarray(x)
        if evidence_mask is None:
            raise ValueError("x requires an evidence_mask")
        mask = _evidence_to_mask(cc, evidence_mask, x.shape[0])
    sq = getattr(cc, "_squared_cc", None)
    if sq is None:
        sq = cc._squared_cc = ctx.multiply(cc, cc)
    full = {**ctx.parameters, **(store or {})}
    # integrate the FREE variables of p^2 and of p: H2 = -(log int p~^2 -
    # 2 log p~(e)); per-sample runtime masks, no recompilation
    l2 = IntegrateQuery(sq)(x, integrate_vars=~mask, store=full)
    lz = IntegrateQuery(cc)(x, integrate_vars=~mask, store=full)
    h2 = -(l2 - 2.0 * lz)
    return h2[0] if unconditional else h2


def _mix_kl(lzp, lzq, kl, wp, wq):
    """One sum reduction of the KL carrier: composite (log Z^p, log Z^q,
    KL) triples (F, B, M) x both weight rows (F, O, M) -> output triples.

    ``KL_o = sum_m pi^p_m [KL_m + log pi^p_m - log pi^q_m]`` with
    ``log pi_m = log w_om + lz_m - lz_o`` — again exp-weighted matmuls
    after the p-side max shift; the constant ``- lz^p_o + lz^q_o`` exits
    the sum because ``sum_m pi^p_m = 1``."""
    hp = jax.lax.Precision.HIGHEST
    shift = jnp.clip(
        jnp.max(lzp, axis=2, keepdims=True),
        jnp.finfo(lzp.dtype).min,
        jnp.finfo(lzp.dtype).max,
    )
    e = jnp.exp(lzp - shift)  # zeros where lzp = -inf
    a = jnp.einsum("fbm,fom->fbo", e, wp, precision=hp)
    safe_a = jnp.maximum(a, jnp.finfo(a.dtype).tiny)
    lzpo = safelog(a) + shift

    shift_q = jnp.clip(
        jnp.max(lzq, axis=2, keepdims=True),
        jnp.finfo(lzq.dtype).min,
        jnp.finfo(lzq.dtype).max,
    )
    eq = jnp.exp(lzq - shift_q)
    aq = jnp.einsum("fbm,fom->fbo", eq, wq, precision=hp)
    lzqo = safelog(aq) + shift_q

    # e * (KL_m + lzp - lzq): guarded where the p-measure vanishes; a q
    # support gap (lzq = -inf with e > 0) legitimately yields +inf
    t1 = jnp.where(e > 0, e * (kl + lzp - lzq), 0.0)
    s1 = jnp.einsum("fbm,fom->fbo", t1, wp, precision=hp)
    wdiff = jnp.where(wp > 0, wp * (safelog(wp) - safelog(wq)), 0.0)
    s2 = jnp.einsum("fbm,fom->fbo", e, wdiff, precision=hp)
    klo = jnp.where(a > 0, (s1 + s2) / safe_a - lzpo + lzqo, 0.0)
    return lzpo, lzqo, klo


def _build_kl_run(cc: JaxCircuit):
    def leaf(layer, st, xin, mrow):
        sp, sq = st
        obs_p = layer(sp, xin)
        obs_q = layer(sq, xin)
        lzp = jnp.where(mrow, obs_p, layer.integrate(sp)[:, None, :])
        lzq = jnp.where(mrow, obs_q, layer.integrate(sq)[:, None, :])
        kl = jnp.where(
            mrow, jnp.zeros_like(obs_p), layer.unit_kl(sp, sq)[:, None, :]
        )
        return lzp, lzq, kl

    def mix(stats, layer, st):
        lzp, lzq, kl = stats
        return _mix_kl(lzp, lzq, kl, layer.weight(st[0]), layer.weight(st[1]))

    run = _build_stat_run(cc, "KLDivergenceQuery", leaf, mix)

    def _run(st, xx, mk):
        return run(st, xx, mk)[2]

    return _run
