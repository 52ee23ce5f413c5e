"""Cross-circuit expectations and divergences via pairwise traversal.

``E_p[log q]`` and ``KL(p || q)`` between two DIFFERENT (but compatible)
circuits, plus an exact structural-determinism verifier. Extensions
beyond the reference, whose query surface is integration/sampling only
(ref: ``cirkit/backend/torch/queries.py:19-275``); the existing
:class:`cirkit_tpu.backend.jax.entropy.KLDivergenceQuery` compares two
parameterizations of ONE circuit — this module compares two circuits
with different structures. The unit pairing is the one the product
operator builds (``cirkit_tpu/symbolic/functional.py:153``, ref
``symbolic/functional.py:259-415``), but the carriers differ.

For a pair ``(n, m)`` of same-scope units (``n`` from ``p``, ``m`` from
``q``) define

    P(n, m) = int p~_n(x) * s_m(x) dx
    C(n, m) = int p~_n(x) * s_m(x) * log q~_m(x) dx

with ``s_m`` the support indicator of q's unit ``m``. When q is
DETERMINISTIC (every sum's positively-weighted inputs have pairwise
disjoint supports), ``log q~`` decomposes along q's parse tree and
``(P, C)`` close under the recursion (Vergari et al., "A Compositional
Atlas of Tractable Circuit Operations", NeurIPS 2021 — the
cross-entropy / KLD rows of the tractability table):

- input pair: closed form per leaf-family pair (tabular x tabular,
  Gaussian x Gaussian);
- product pair: ``P`` multiplies and ``C`` follows the Leibniz rule
  over the scope-matched child pairs (disjoint scopes);
- sum pair (p-side row ``A``, q-side row ``B``):
  ``P(o1, o2) = sum_a sum_{b: B_b > 0} A_a P(a, b)`` and
  ``C(o1, o2) = sum_a sum_{b: B_b > 0} A_a (C(a, b) + log B_b P(a, b))``
  — q's weights gate SUPPORT (hence the ``B > 0`` mask, not ``B``),
  while ``log B_b`` enters additively because on ``supp(m_b)`` the
  deterministic sum satisfies ``log q~_m = log B_b + log q~_{m_b}``.

Carried as ``(log P, r = C / P)``, every sum reduction is a two-stage
exp-weighted matmul after per-row max shifts — the same numerics as
``EntropyQuery``'s. At the root, ``E_p[log q] = r - log Z_q`` whenever
``P = Z_p`` (q's support covers p's mass) and ``-inf`` otherwise;
``KL(p || q) = -H(p) - E_p[log q]`` with ``H(p)`` exact from
``EntropyQuery`` when p is deterministic too.

By default everything runs host-side in float64 over the SYMBOLIC
graphs, with the trained parameters read back through the pipeline
context (the same shared-state sibling-compile mechanism structural
pruning uses) — exact, aimed at modest logic/SDD-sized circuits.
``device=True`` (r5) executes the same recursion through jitted
on-device kernels with a vectorized sum reduction: the traversal stays
host Python, jax.jit caches one program per distinct pair shape, and
only the root carriers are pulled. Accuracy follows the platform float
width (f32: ~1e-4 nats; float64 under the CPU x64 config, pinned
against the host path at 1e-9).

Scaling note (measured, r5): the pair recursion enumerates
``arity_p x arity_q`` child pairs per sum pair, so HIGH-ARITY
deterministic sums (e.g. ``distill_tree``'s 256-way indicator mixtures)
blow the walk up quadratically on BOTH paths — that is a property of
the compositional cross-operator itself, not the executor. For such
circuits the two useful cases are already served elsewhere: two
parameterizations of ONE skeleton -> :class:`KLDivergenceQuery` (a
single device pass; exact when deterministic — this covers comparing
two distill_tree outputs, which are only scope-compatible when they
share the skeleton), and non-deterministic or incompatible pairs ->
the Monte Carlo estimators below. The pairwise module targets
DIFFERENT-structure deterministic pairs with modest sum arities
(logic/SDD weighted-model-count distributions), where ``device=True``
moves the carrier math on-chip.
"""

from __future__ import annotations

import itertools
import math
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np

from cirkit_tpu.symbolic.circuit import Circuit, are_compatible
from cirkit_tpu.symbolic.layers import (
    BinomialLayer,
    CategoricalLayer,
    EmbeddingLayer,
    GaussianLayer,
    HadamardLayer,
    InputLayer,
    KroneckerLayer,
    Layer,
    SumLayer,
)

__all__ = [
    "cross_circuit_kl",
    "expected_loglikelihood",
    "expected_loglikelihood_mc",
    "is_deterministic",
    "kl_monte_carlo",
]


# --------------------------------------------------------------------------
# parameter readback: evaluation-consistent host tables
# --------------------------------------------------------------------------


def _materialize_tables(sc: Circuit, ctx, store) -> dict[Layer, Any]:
    """Per-symbolic-layer host float64 values that match the compiled
    circuit's pointwise evaluation EXACTLY (up to f32 rounding): sum
    layers map to their materialized weight rows, discrete leaves to the
    full ``(K, S)`` unnormalized state table ``p~(x = s)``, Gaussians to
    ``("gaussian", mean, stddev)``. Same shared-state sibling-compile
    readback as :func:`cirkit_tpu.backend.jax.pruning.prune_circuit`."""
    import jax

    from cirkit_tpu.backend.jax.compiler import JaxCompiler

    base = ctx._compiler
    if not base.is_compiled(sc):
        raise ValueError(
            "Compile the circuit through this context first (ctx.compile(sc)): "
            "cross-circuit queries read the trained parameters back through "
            "the context's slot state"
        )
    raw = JaxCompiler(semiring=base._flags["semiring"], fold=True, optimize=False)
    raw.state = base.state
    cc = raw.compile(sc)
    placement = cc._symbolic_fold
    assert placement is not None  # unoptimized compile always retains it

    values: dict[Layer, Any] = {}
    for sl, (pi, f) in placement.items():
        jl = cc._entries[pi].layer
        if isinstance(sl, SumLayer):
            w = np.asarray(jl.weight(store), np.float64)[f]
            if (w < 0).any():
                raise NotImplementedError(
                    "Cross-circuit queries require nonnegative sum weights "
                    "(probability semantics); found negative entries"
                )
            values[sl] = w
        elif isinstance(sl, CategoricalLayer):
            values[sl] = np.exp(np.asarray(jl._log_probs(store), np.float64)[f])
        elif isinstance(sl, EmbeddingLayer):
            t = np.asarray(jl.weight(store), np.float64)[f]
            if (t < 0).any():
                raise NotImplementedError(
                    "Cross-circuit queries require nonnegative embedding "
                    "tables (probability semantics); found negative entries"
                )
            values[sl] = t
        elif isinstance(sl, BinomialLayer):
            p = np.asarray(jax.nn.sigmoid(jl._logits(store)), np.float64)[f]
            n = sl.total_count
            s = np.arange(n + 1, dtype=np.float64)
            comb = np.array([math.comb(n, int(i)) for i in range(n + 1)], np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                logt = (
                    np.log(comb)[None, :]
                    + s[None, :] * np.log(p)[:, None]
                    + (n - s)[None, :] * np.log1p(-p)[:, None]
                )
            # p = 0 / 1 edges: the pmf is a point mass at 0 / n
            logt = np.where(np.isnan(logt), -np.inf, logt)
            values[sl] = np.exp(logt)
        elif isinstance(sl, GaussianLayer):
            if sl.log_partition is not None:
                raise NotImplementedError(
                    "Cross-circuit queries over unnormalized (log-partition) "
                    "Gaussian layers are not supported"
                )
            values[sl] = (
                "gaussian",
                np.asarray(jl.mean(store), np.float64)[f],
                np.asarray(jl.stddev(store), np.float64)[f],
            )
        elif isinstance(sl, (HadamardLayer, KroneckerLayer)):
            pass  # parameterless
        else:
            raise NotImplementedError(
                f"Cross-circuit queries are not supported for {type(sl).__name__}"
            )
    return values


def _is_gaussian(v: Any) -> bool:
    return isinstance(v, tuple) and v and v[0] == "gaussian"


def _log_partition(sc: Circuit, values: dict[Layer, Any]) -> dict[Layer, np.ndarray]:
    """Per-layer ``(K,)`` log partition vectors of the unnormalized
    measure, bottom-up on the host (float64, per-row max shifts)."""
    z: dict[Layer, np.ndarray] = {}
    for sl in sc.topological_ordering():
        if isinstance(sl, InputLayer):
            v = values[sl]
            if _is_gaussian(v):
                z[sl] = np.zeros(sl.num_output_units)
            else:
                with np.errstate(divide="ignore"):
                    z[sl] = np.log(v.sum(axis=1))
        elif isinstance(sl, HadamardLayer):
            z[sl] = sum(z[c] for c in sc.layer_inputs(sl))
        elif isinstance(sl, KroneckerLayer):
            out = np.zeros(1)
            for c in sc.layer_inputs(sl):  # first child most significant
                out = (out[:, None] + z[c][None, :]).reshape(-1)
            z[sl] = out
        elif isinstance(sl, SumLayer):
            comp = np.concatenate([z[c] for c in sc.layer_inputs(sl)])
            w = values[sl]  # (O, H*K)
            s = comp.max()
            s = s if np.isfinite(s) else 0.0
            with np.errstate(divide="ignore"):
                z[sl] = np.log(w @ np.exp(comp - s)) + s
        else:
            raise NotImplementedError(
                f"Cross-circuit queries are not supported for {type(sl).__name__}"
            )
    return z


# --------------------------------------------------------------------------
# the generic pairwise walker
# --------------------------------------------------------------------------

_Pair = tuple[Layer, Layer]
_Val = tuple[np.ndarray, ...]


def _assemble_sum_comp(vals: Sequence[_Val], a1: int, a2: int) -> _Val:
    """Child pair values (``itertools.product`` order, h1-major) into the
    flat sum composites: per carrier, ``(a1 * K1, a2 * K2)`` with the
    p-side flat index ``h1 * K1 + k`` (the concat-over-arity layout of
    ``SumLayer`` weights) and likewise on the q side."""
    import jax.numpy as jnp

    out = []
    for c in range(len(vals[0])):
        k1, k2 = vals[0][c].shape
        if isinstance(vals[0][c], jnp.ndarray):
            # device carriers: one stack+transpose dispatch, no host pulls
            x = jnp.stack([v[c] for v in vals]).reshape(a1, a2, k1, k2)
            out.append(jnp.transpose(x, (0, 2, 1, 3)).reshape(a1 * k1, a2 * k2))
            continue
        x = np.empty((a1, k1, a2, k2), dtype=vals[0][c].dtype)
        i = 0
        for h1 in range(a1):
            for h2 in range(a2):
                x[h1, :, h2, :] = vals[i][c]
                i += 1
        out.append(x.reshape(a1 * k1, a2 * k2))
    return tuple(out)


def _assemble_kron(
    vals_pos: Sequence[tuple[int, int, _Val]],
    h1: int,
    h2: int,
    k1: int,
    k2: int,
    ops: Sequence[Callable[[np.ndarray, np.ndarray], np.ndarray]],
    inits: Sequence[Any],
) -> _Val:
    """Scope-matched child pair values into Kronecker composite pairs:
    per carrier a ``(k1**h1, k2**h2)`` array where digit ``i`` of the
    p-side composite follows p's OWN child order (first most
    significant) and digit ``j`` of the q-side follows q's — the two
    orders may differ, hence the ``(i, j)`` position pairs."""
    import jax.numpy as jnp

    on_device = isinstance(vals_pos[0][2][0], jnp.ndarray)
    outs = []
    for c, (op, init) in enumerate(zip(ops, inits)):
        shape = (k1,) * h1 + (k2,) * h2
        acc = jnp.full(shape, init) if on_device else np.full(shape, init)
        for i, j, tup in vals_pos:
            b = [1] * (h1 + h2)
            b[i] = k1
            b[h1 + j] = k2
            acc = op(acc, tup[c].reshape(b))
        outs.append(acc.reshape(k1**h1, k2**h2))
    return tuple(outs)


def _pairwise_walk(
    sc1: Circuit,
    sc2: Circuit,
    input_fn: Callable[[Layer, Layer], _Val],
    sum_fn: Callable[[Layer, Layer, _Val], _Val],
    ops: Sequence[Callable[[np.ndarray, np.ndarray], np.ndarray]],
    inits: Sequence[Any],
) -> dict[_Pair, _Val]:
    """Bottom-up traversal over the product-operator unit pairing of two
    compatible circuits. ``input_fn`` seeds same-scope leaf pairs with a
    carrier tuple of ``(K1, K2)`` arrays; product pairs combine the
    scope-matched child pairs with ``ops``/``inits`` (elementwise for
    Hadamard, digit-tensorized for Kronecker); sum pairs get the
    assembled ``(A1*K1, A2*K2)`` composite tuple via ``sum_fn``."""
    pair_val: dict[_Pair, _Val] = {}
    stack: list[_Pair] = list(itertools.product(sc1.outputs, sc2.outputs))
    while stack:
        pair = stack[-1]
        if pair in pair_val:
            stack.pop()
            continue
        l1, l2 = pair
        if sc1.layer_scope(l1) != sc2.layer_scope(l2):
            raise NotImplementedError(
                "Cross-circuit queries require identically aligned scope "
                f"partitions; paired layers have scopes {sc1.layer_scope(l1)} "
                f"and {sc2.layer_scope(l2)}"
            )
        in1, in2 = isinstance(l1, InputLayer), isinstance(l2, InputLayer)
        if in1 and in2:
            pair_val[pair] = input_fn(l1, l2)
            stack.pop()
            continue
        # one side may be deeper than the other over the same scope (e.g.
        # a smoothing sum over literal indicators paired with a bare
        # leaf): treat the leaf side as an identity-weighted trivial sum
        if (in1 and isinstance(l2, SumLayer)) or (in2 and isinstance(l1, SumLayer)):
            ins1 = [l1] if in1 else list(sc1.layer_inputs(l1))
            ins2 = [l2] if in2 else list(sc2.layer_inputs(l2))
            children = list(itertools.product(ins1, ins2))
            missing = [p for p in children if p not in pair_val]
            if missing:
                stack.extend(missing)
                continue
            comp = _assemble_sum_comp(
                [pair_val[p] for p in children],
                1 if in1 else l1.arity,
                1 if in2 else l2.arity,
            )
            pair_val[pair] = sum_fn(l1, l2, comp)
            stack.pop()
            continue
        if in1 or in2:
            raise NotImplementedError(
                "Cross-circuit queries cannot pair an input layer with "
                f"a {type(l2 if in1 else l1).__name__}"
            )
        if isinstance(l1, SumLayer) and isinstance(l2, SumLayer):
            children = list(
                itertools.product(sc1.layer_inputs(l1), sc2.layer_inputs(l2))
            )
            missing = [p for p in children if p not in pair_val]
            if missing:
                stack.extend(missing)
                continue
            comp = _assemble_sum_comp(
                [pair_val[p] for p in children], l1.arity, l2.arity
            )
            pair_val[pair] = sum_fn(l1, l2, comp)
            stack.pop()
            continue
        if type(l1) is not type(l2) or not isinstance(l1, (HadamardLayer, KroneckerLayer)):
            raise NotImplementedError(
                f"Cross-circuit queries cannot pair {type(l1).__name__} with "
                f"{type(l2).__name__}"
            )
        ins1 = list(sc1.layer_inputs(l1))
        ins2 = list(sc2.layer_inputs(l2))
        by_scope: dict[Any, tuple[int, Layer]] = {}
        for j, c2 in enumerate(ins2):
            key = tuple(sorted(sc2.layer_scope(c2)))
            if key in by_scope:
                raise NotImplementedError(
                    "Cross-circuit queries require distinct child scopes per "
                    "product layer"
                )
            by_scope[key] = (j, c2)
        matched: list[tuple[int, int, _Pair]] = []
        for i, c1 in enumerate(ins1):
            key = tuple(sorted(sc1.layer_scope(c1)))
            if key not in by_scope:
                raise NotImplementedError(
                    "Cross-circuit queries require identically aligned scope "
                    f"partitions; no match for child scope {key}"
                )
            j, c2 = by_scope[key]
            matched.append((i, j, (c1, c2)))
        missing = [p for _, _, p in matched if p not in pair_val]
        if missing:
            stack.extend(missing)
            continue
        if isinstance(l1, HadamardLayer):
            acc: _Val | None = None
            for _, _, p in matched:
                v = pair_val[p]
                acc = v if acc is None else tuple(op(a, b) for op, a, b in zip(ops, acc, v))
            assert acc is not None
            pair_val[pair] = acc
        else:  # Kronecker
            pair_val[pair] = _assemble_kron(
                [(i, j, pair_val[p]) for i, j, p in matched],
                l1.arity,
                l2.arity,
                l1.num_input_units,
                l2.num_input_units,
                ops,
                inits,
            )
        stack.pop()
    return pair_val


# --------------------------------------------------------------------------
# the (log P, r) cross-expectation carriers
# --------------------------------------------------------------------------


def _cross_input(v1: Any, v2: Any, l1: Layer, l2: Layer) -> _Val:
    if _is_gaussian(v1) and _is_gaussian(v2):
        _, mp, sp = v1
        _, mq, sq = v2
        r = (
            -0.5 * np.log(2.0 * np.pi * sq[None, :] ** 2)
            - (sp[:, None] ** 2 + (mp[:, None] - mq[None, :]) ** 2)
            / (2.0 * sq[None, :] ** 2)
        )
        return np.zeros_like(r), r
    if _is_gaussian(v1) or _is_gaussian(v2):
        raise NotImplementedError(
            "Cross-circuit queries cannot pair a Gaussian input with a "
            "finite-support input over the same variable"
        )
    if v1.shape[1] != v2.shape[1]:
        raise NotImplementedError(
            f"Paired {type(l1).__name__}/{type(l2).__name__} inputs disagree "
            f"on the state count: {v1.shape[1]} vs {v2.shape[1]}"
        )
    mq = v2 > 0
    with np.errstate(divide="ignore"):
        logt = np.where(mq, np.log(np.where(mq, v2, 1.0)), 0.0)
    p = v1 @ mq.T  # (K1, K2)
    c = v1 @ (mq * logt).T
    with np.errstate(divide="ignore"):
        lp = np.log(p)
    r = np.where(p > 0, c / np.maximum(p, np.finfo(np.float64).tiny), 0.0)
    return lp, r


def _cross_sum(a: np.ndarray, b: np.ndarray, lp: np.ndarray, r: np.ndarray) -> _Val:
    """Two-stage reduction of the ``(log P, r)`` composite ``(Ma, Mb)``
    under the p-side weights ``a`` ``(O1, Ma)`` and q-side support/log-
    weights from ``b`` ``(O2, Mb)``. Stage 1 sums q's supported branches
    per p-composite (per-row max shift); stage 2 mixes p's composites
    per output with an exactly-masked shift (loop over p's output units;
    these are host-side circuits with modest widths)."""
    mb = b > 0
    with np.errstate(divide="ignore"):
        logb = np.where(mb, np.log(np.where(mb, b, 1.0)), 0.0)
    s1 = lp.max(axis=1, keepdims=True)  # (Ma, 1)
    s1 = np.where(np.isfinite(s1), s1, 0.0)
    e = np.exp(lp - s1)  # zeros where log P = -inf
    p1 = e @ mb.T  # (Ma, O2)
    n1 = (e * r) @ mb.T + e @ (mb * logb).T
    with np.errstate(divide="ignore"):
        lp1 = np.log(p1) + s1
    r1 = np.where(p1 > 0, n1 / np.maximum(p1, np.finfo(np.float64).tiny), 0.0)

    o1, o2 = a.shape[0], b.shape[0]
    lp_out = np.full((o1, o2), -np.inf)
    r_out = np.zeros((o1, o2))
    for i in range(o1):
        rowmask = a[i] > 0
        if not rowmask.any():
            continue
        aw = a[i][rowmask]
        sub_lp = lp1[rowmask]  # (na, O2)
        sub_r = r1[rowmask]
        s2 = sub_lp.max(axis=0)  # (O2,)
        s2f = np.where(np.isfinite(s2), s2, 0.0)
        e2 = np.exp(sub_lp - s2f[None, :])
        p2 = aw @ e2  # (O2,)
        n2 = aw @ (e2 * sub_r)
        with np.errstate(divide="ignore"):
            lp_out[i] = np.log(p2) + s2f
        r_out[i] = np.where(p2 > 0, n2 / np.maximum(p2, np.finfo(np.float64).tiny), 0.0)
    return lp_out, r_out


# --------------------------------------------------------------------------
# device (jitted) carrier programs
# --------------------------------------------------------------------------
# The host walk is float64 and exact, but it is a CPU island: at
# distill_tree scale (~784 leaf + ~784 sum pairs of 256-wide units) the
# numpy stage-2 reduction alone is tens of seconds. ``device=True`` runs
# the SAME pairwise recursion with jitted carrier kernels: the traversal
# stays host Python (graph bookkeeping), every array op is a cached jitted
# program (jax.jit caches per shape — homogeneous circuits compile a
# handful of programs and then dispatch in ~ms), and only the final
# (K_p, K_q) root carriers are pulled. Stage 2 of the sum reduction is
# vectorized over the p-side output units with a masked shift instead of
# the host loop. Accuracy follows the device float width (f32: ~1e-4 nats;
# float64 under the CPU test config, where it pins against the host path
# at 1e-9).


def _dev_cross_input_tab(v1, v2):
    import jax.numpy as jnp

    mq = v2 > 0
    logt = jnp.where(mq, jnp.log(jnp.where(mq, v2, 1.0)), 0.0)
    p = v1 @ mq.T.astype(v1.dtype)
    c = v1 @ (mq * logt).T.astype(v1.dtype)
    lp = jnp.log(p)
    tiny = jnp.finfo(p.dtype).tiny
    r = jnp.where(p > 0, c / jnp.maximum(p, tiny), 0.0)
    return lp, r


def _dev_cross_input_gauss(mp, sp, mq, sq):
    import jax.numpy as jnp

    r = (
        -0.5 * jnp.log(2.0 * jnp.pi * sq[None, :] ** 2)
        - (sp[:, None] ** 2 + (mp[:, None] - mq[None, :]) ** 2)
        / (2.0 * sq[None, :] ** 2)
    )
    return jnp.zeros_like(r), r


def _dev_cross_sum(a, b, lp, r):
    import jax.numpy as jnp

    tiny = jnp.finfo(lp.dtype).tiny
    mb = b > 0
    logb = jnp.where(mb, jnp.log(jnp.where(mb, b, 1.0)), 0.0)
    s1 = jnp.max(lp, axis=1, keepdims=True)
    s1 = jnp.where(jnp.isfinite(s1), s1, 0.0)
    e = jnp.exp(lp - s1)
    mbt = mb.T.astype(e.dtype)
    p1 = e @ mbt
    n1 = (e * r) @ mbt + e @ (mb * logb).T.astype(e.dtype)
    lp1 = jnp.log(p1) + s1
    r1 = jnp.where(p1 > 0, n1 / jnp.maximum(p1, tiny), 0.0)
    # stage 2, vectorized over p's output units with an exactly-masked shift
    am = a > 0  # (O1, Ma)
    neg = jnp.asarray(-jnp.inf, lp1.dtype)
    lpm = jnp.where(am[:, :, None], lp1[None], neg)  # (O1, Ma, O2)
    s2 = jnp.max(lpm, axis=1)
    s2f = jnp.where(jnp.isfinite(s2), s2, 0.0)
    e2 = jnp.exp(lpm - s2f[:, None, :])  # masked rows: exp(-inf) = 0
    p2 = jnp.einsum("om,omq->oq", a, e2)
    n2 = jnp.einsum("om,omq->oq", a, e2 * jnp.where(am[:, :, None], r1[None], 0.0))
    lp_out = jnp.log(p2) + s2f
    r_out = jnp.where(p2 > 0, n2 / jnp.maximum(p2, tiny), 0.0)
    return lp_out, r_out


_DEV_JITS: dict = {}


def _dev_jit(name, fn):
    import jax

    if name not in _DEV_JITS:
        _DEV_JITS[name] = jax.jit(fn)
    return _DEV_JITS[name]


def _device_tables(values: dict) -> dict:
    """Push the host float64 tables to the device float width once."""
    import jax.numpy as jnp

    dt = jnp.result_type(float)
    out = {}
    for sl, v in values.items():
        if _is_gaussian(v):
            out[sl] = ("gaussian", jnp.asarray(v[1], dt), jnp.asarray(v[2], dt))
        else:
            out[sl] = jnp.asarray(v, dt)
    return out


def _single_root(sc: Circuit, name: str) -> Layer:
    if len(sc.outputs) != 1:
        raise NotImplementedError(f"{name} supports single-output circuits only")
    return sc.outputs[0]


def _resolve_store(ctx, store) -> dict:
    full = dict(ctx.parameters)
    if store is not None:
        full.update(store)
    return full


def expected_loglikelihood(
    sc_p: Circuit,
    sc_q: Circuit,
    *,
    ctx,
    store_p=None,
    store_q=None,
    check: bool = True,
    device: bool = False,
) -> np.ndarray:
    """Exact ``E_{x ~ p}[log q(x)]`` between two compatible circuits.

    ``device=True`` runs the carrier recursion through jitted on-device
    kernels (the traversal stays host Python; jax.jit caches one program
    per distinct pair shape, so homogeneous circuits — e.g. distill_tree
    outputs — compile a handful of programs and then dispatch in
    milliseconds). Accuracy follows the device float width: f32
    (~1e-4 nats), float64 under an x64 config, where it matches the host
    path at 1e-9 (pinned in tests/backend/test_cross.py).

    Both circuits must be compiled through ``ctx`` (their trained
    parameters are read back through its slot state; ``store_p`` /
    ``store_q`` merge over ``ctx.parameters``). Requires ``q``
    DETERMINISTIC — verified by :func:`is_deterministic` when ``check``
    is True (p may be any compatible circuit). Returns the ``(K_p,
    K_q)`` matrix over root-unit pairs, each entry the expected
    log-likelihood of q's normalized unit distribution under p's;
    ``-inf`` where q's support misses p's mass. A support
    double-counting guard raises if q turns out non-deterministic at
    the numbers level even with ``check=False``."""
    if not are_compatible(sc_p, sc_q):
        raise ValueError(
            "Cross-circuit queries require compatible circuits (identical "
            "hierarchical scope partitioning)"
        )
    if check and not is_deterministic(sc_q, ctx=ctx, store=store_q):
        raise ValueError(
            "E_p[log q] is tractable only for deterministic q (every sum's "
            "positively-weighted inputs with disjoint supports); pass "
            "check=False to skip this verification at your own risk"
        )
    # side-specific tables: a layer shared between the two circuits (or the
    # same circuit under two stores) reads p's values on the left, q's on
    # the right
    vp = _materialize_tables(sc_p, ctx, _resolve_store(ctx, store_p))
    vq = _materialize_tables(sc_q, ctx, _resolve_store(ctx, store_q))

    if device:
        import jax.numpy as jnp

        dvp, dvq = _device_tables(vp), _device_tables(vq)
        itab = _dev_jit("input_tab", _dev_cross_input_tab)
        igau = _dev_jit("input_gauss", _dev_cross_input_gauss)
        dsum = _dev_jit("sum", _dev_cross_sum)
        dt = jnp.result_type(float)
        eyes: dict[int, Any] = {}

        def input_fn(l1: Layer, l2: Layer) -> _Val:
            v1, v2 = dvp[l1], dvq[l2]
            if _is_gaussian(v1) and _is_gaussian(v2):
                return igau(v1[1], v1[2], v2[1], v2[2])
            if _is_gaussian(v1) or _is_gaussian(v2):
                raise NotImplementedError(
                    "Cross-circuit queries cannot pair a Gaussian input "
                    "with a finite-support input over the same variable"
                )
            if v1.shape[1] != v2.shape[1]:
                raise NotImplementedError(
                    f"Paired {type(l1).__name__}/{type(l2).__name__} inputs "
                    f"disagree on the state count: {v1.shape[1]} vs {v2.shape[1]}"
                )
            return itab(v1, v2)

        def _eye(k):
            if k not in eyes:
                eyes[k] = jnp.eye(k, dtype=dt)
            return eyes[k]

        def sum_fn(l1: Layer, l2: Layer, comp: _Val) -> _Val:
            a = dvp[l1] if isinstance(l1, SumLayer) else _eye(l1.num_output_units)
            b = dvq[l2] if isinstance(l2, SumLayer) else _eye(l2.num_output_units)
            return dsum(a, b, *comp)

        ops = (jnp.add, jnp.add)
    else:

        def input_fn(l1: Layer, l2: Layer) -> _Val:
            return _cross_input(vp[l1], vq[l2], l1, l2)

        def sum_fn(l1: Layer, l2: Layer, comp: _Val) -> _Val:
            # a leaf paired against a (deeper) sum acts as an identity-
            # weighted trivial sum on its side
            a = vp[l1] if isinstance(l1, SumLayer) else np.eye(l1.num_output_units)
            b = vq[l2] if isinstance(l2, SumLayer) else np.eye(l2.num_output_units)
            return _cross_sum(a, b, *comp)

        ops = (np.add, np.add)

    pv = _pairwise_walk(sc_p, sc_q, input_fn, sum_fn, ops=ops, inits=(0.0, 0.0))
    rp = _single_root(sc_p, "expected_loglikelihood")
    rq = _single_root(sc_q, "expected_loglikelihood")
    lp_root, r_root = pv[(rp, rq)]
    if device:
        lp_root = np.asarray(lp_root, np.float64)
        r_root = np.asarray(r_root, np.float64)
    logzp = _log_partition(sc_p, vp)[rp]  # (K1,)
    logzq = _log_partition(sc_q, vq)[rq]  # (K2,)
    # device carriers run at the platform float width: scale the support-
    # coverage tolerance accordingly (f32 accumulates ~1e-5 relative)
    rel = 1e-6
    if device:
        import jax.numpy as jnp

        rel = 1e-6 if jnp.result_type(float) == jnp.float64 else 1e-4
    tol = rel * np.maximum(1.0, np.abs(logzp))[:, None]
    if (lp_root > logzp[:, None] + tol).any():
        raise ValueError(
            "Support double-counting detected (the restricted mass exceeds "
            "p's partition function): q is not deterministic, so E_p[log q] "
            "is intractable for this pair"
        )
    covered = lp_root >= logzp[:, None] - tol
    return np.where(covered, r_root - logzq[None, :], -np.inf)


def cross_circuit_kl(
    sc_p: Circuit,
    sc_q: Circuit,
    *,
    ctx,
    store_p=None,
    store_q=None,
    check: bool = True,
    device: bool = False,
) -> np.ndarray:
    """Exact ``KL(p || q)`` between two compatible DETERMINISTIC circuits
    with different structures: ``-H(p) - E_p[log q]``, the entropy from
    :class:`cirkit_tpu.backend.jax.entropy.EntropyQuery` (exact for
    deterministic p) and the cross term from
    :func:`expected_loglikelihood`. ``+inf`` where q's support misses
    p's. Returns the ``(K_p, K_q)`` matrix over root-unit pairs. Both
    circuits must be compiled through ``ctx`` under the 'lse-sum'
    semiring. For two parameterizations of ONE circuit prefer
    :class:`~cirkit_tpu.backend.jax.entropy.KLDivergenceQuery` (one
    device pass, batch evidence support)."""
    from cirkit_tpu.backend.jax.entropy import EntropyQuery

    if check and not is_deterministic(sc_p, ctx=ctx, store=store_p):
        raise ValueError(
            "cross_circuit_kl is exact only for deterministic p (its "
            "entropy term); pass check=False to skip this verification"
        )
    ell = expected_loglikelihood(
        sc_p, sc_q, ctx=ctx, store_p=store_p, store_q=store_q, check=check,
        device=device,
    )
    cc_p = ctx.compile(sc_p)
    ent = np.asarray(
        EntropyQuery(cc_p)(store=_resolve_store(ctx, store_p)), np.float64
    )[0]  # (K1,)
    return -ent[:, None] - ell


# --------------------------------------------------------------------------
# determinism verification (exact for finite-support leaves)
# --------------------------------------------------------------------------


def is_deterministic(
    sc: Circuit,
    *,
    ctx,
    store=None,
    return_report: bool = False,
):
    """Whether the circuit is DETERMINISTIC under its current parameters:
    at every sum unit, the positively-weighted input composites have
    pairwise disjoint supports. Exact (not a heuristic) for circuits
    with finite-support leaves: the walker pairs the circuit with itself
    and carries boolean support-overlap matrices bottom-up — leaves
    overlap where both state tables are positive, Hadamard/Kronecker
    products overlap iff ALL scope-matched factor pairs do, sums union
    their positively-weighted branches. Gaussian leaves always overlap
    (full support), so sums over Gaussian-leaf scopes are deterministic
    only with at most one positive weight per row. Determinism is the
    exactness condition of :class:`EntropyQuery`,
    :class:`KLDivergenceQuery`, and the cross-circuit queries — this
    makes it checkable instead of assumed. ``return_report=True``
    additionally returns the violating layers and unit rows."""
    values = _materialize_tables(sc, ctx, _resolve_store(ctx, store))
    violations: list[tuple[Layer, np.ndarray]] = []

    def input_fn(l1: Layer, l2: Layer) -> _Val:
        v1, v2 = values[l1], values[l2]
        if _is_gaussian(v1) and _is_gaussian(v2):
            return (np.ones((l1.num_output_units, l2.num_output_units), bool),)
        if _is_gaussian(v1) or _is_gaussian(v2):
            raise NotImplementedError(
                "Determinism verification cannot pair a Gaussian input with "
                "a finite-support input over the same variable"
            )
        if v1.shape[1] != v2.shape[1]:
            raise NotImplementedError(
                "Determinism verification requires same-scope inputs to "
                "agree on the state count"
            )
        return (((v1 > 0).astype(np.float64) @ (v2 > 0).T.astype(np.float64)) > 0,)

    def sum_fn(l1: Layer, l2: Layer, comp: _Val) -> _Val:
        (ov,) = comp  # (Ma, Mb) bool
        ma = (
            values[l1] > 0
            if isinstance(l1, SumLayer)
            else np.eye(l1.num_output_units, dtype=bool)
        )  # (O1, Ma)
        mb = (
            values[l2] > 0
            if isinstance(l2, SumLayer)
            else np.eye(l2.num_output_units, dtype=bool)
        )
        if l1 is l2:
            off = ov & ~np.eye(ov.shape[0], dtype=bool)
            hits = ma.astype(np.float64) @ off.astype(np.float64)  # (O, Mb)
            bad = ((hits > 0) & ma).any(axis=1)  # (O,)
            if bad.any():
                violations.append((l1, np.flatnonzero(bad)))
        out = (
            ma.astype(np.float64) @ ov.astype(np.float64) @ mb.T.astype(np.float64)
        ) > 0
        return (out,)

    _pairwise_walk(sc, sc, input_fn, sum_fn, ops=(np.logical_and,), inits=(True,))
    ok = not violations
    return (ok, violations) if return_report else ok


# --------------------------------------------------------------------------
# Monte Carlo estimators: ANY same-scope pair, no determinism required
# --------------------------------------------------------------------------


def _mc_log_terms(cc_p, cc_q, store_p, store_q, num_samples, key, batch_size):
    """Per-sample normalized (log p(x), log q(x)) for x ~ p, drawn in
    fixed-size rounds so one sampling program and one forward per circuit
    serve any ``num_samples``."""
    import jax

    from cirkit_tpu.backend.jax.queries import IntegrateQuery, SamplingQuery
    from cirkit_tpu.utils.scope import Scope

    if set(cc_p.scope) != set(cc_q.scope):
        raise ValueError(
            f"Monte Carlo cross-circuit estimators need identical scopes, "
            f"found {sorted(cc_p.scope)} vs {sorted(cc_q.scope)}"
        )
    if num_samples < 2:
        raise ValueError(f"num_samples must be >= 2, found {num_samples}")
    if store_p is None:
        store_p = getattr(cc_p, "default_store", None)
    if store_q is None:
        store_q = getattr(cc_q, "default_store", None)
    if store_p is None or store_q is None:
        raise ValueError("No parameter store bound; pass store_p=/store_q=")
    if key is None:
        key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))

    sq = SamplingQuery(cc_p)
    b = min(batch_size, num_samples)
    lps: list[np.ndarray] = []
    lqs: list[np.ndarray] = []
    drawn = 0
    probe = None
    while drawn < num_samples:
        key, sub = jax.random.split(key)
        x, _ = sq(b, key=sub, store=store_p)
        x = np.asarray(x)
        if probe is None:
            probe = x[:1]
        lps.append(np.asarray(cc_p(store_p, x)).reshape(b, -1)[:, 0])
        lqs.append(np.asarray(cc_q(store_q, x)).reshape(b, -1)[:, 0])
        drawn += b
    lp = np.concatenate(lps)[:num_samples].astype(np.float64)
    lq = np.concatenate(lqs)[:num_samples].astype(np.float64)
    logzp = float(
        np.asarray(
            IntegrateQuery(cc_p)(
                probe, integrate_vars=Scope(cc_p.scope), store=store_p
            )
        ).reshape(-1)[0]
    )
    logzq = float(
        np.asarray(
            IntegrateQuery(cc_q)(
                probe, integrate_vars=Scope(cc_q.scope), store=store_q
            )
        ).reshape(-1)[0]
    )
    return lp - logzp, lq - logzq


def _support_violated(lq: np.ndarray) -> bool:
    """True when q assigned zero density to a drawn sample. Log-space
    forwards floor ``log 0`` at the dtype minimum rather than ``-inf``
    (the -1e30-style clamps, or float32's ~-3.4e38 minimum), so
    "zero" means any value at or beyond the -1e30 clamp — far below any
    real normalized log density, but above the clamps so they're caught."""
    return bool(np.any(~np.isfinite(lq)) or np.any(lq <= -1e29))


def expected_loglikelihood_mc(
    cc_p,
    cc_q,
    *,
    num_samples: int = 4096,
    key=None,
    store_p=None,
    store_q=None,
    batch_size: int = 1024,
) -> tuple[float, float]:
    """Monte Carlo ``E_{x ~ p}[log q(x)]`` for ANY same-scope compiled pair.

    The exact :func:`expected_loglikelihood` requires q deterministic and
    p compatible — in general the expectation is #P-hard. This estimator
    only needs ancestral sampling from ``p`` (smooth + decomposable) and a
    forward pass of ``q``: it draws ``num_samples`` ancestral samples in
    ``batch_size`` rounds, evaluates both NORMALIZED log densities, and
    returns ``(estimate, standard_error)``. Works across structures,
    scopes permuted the same, discrete or continuous leaves. Returns
    ``(-inf, nan)`` when q assigns zero density to a drawn sample (a
    support violation no sample count can average away).

    Head convention: samples come from p's root distribution and both
    circuits are read at output unit 0 (multi-head circuits: restrict
    first). Unbiased in ``exp``-space terms; the standard error is the
    plain per-sample deviation over ``sqrt(num_samples)``.
    """
    lp, lq = _mc_log_terms(
        cc_p, cc_q, store_p, store_q, num_samples, key, batch_size
    )
    if _support_violated(lq):
        return float("-inf"), float("nan")
    return float(lq.mean()), float(lq.std(ddof=1) / math.sqrt(len(lq)))


def kl_monte_carlo(
    cc_p,
    cc_q,
    *,
    num_samples: int = 4096,
    key=None,
    store_p=None,
    store_q=None,
    batch_size: int = 1024,
) -> tuple[float, float]:
    """Monte Carlo ``KL(p || q)`` for ANY same-scope compiled pair.

    Complements the exact routes — :class:`~cirkit_tpu.backend.jax.
    entropy.KLDivergenceQuery` (two stores of ONE circuit; exact only if
    deterministic, else a DPI upper bound) and :func:`cross_circuit_kl`
    (different structures, both deterministic) — with an unbiased
    estimator that holds for arbitrary smooth decomposable circuits:
    ``mean(log p(x) - log q(x))`` over ancestral samples ``x ~ p``, both
    terms normalized internally (neither circuit needs ``Z = 1``).
    Returns ``(estimate, standard_error)``; ``(+inf, nan)`` when q misses
    p's support at a drawn sample. Pairing identical circuit+store gives
    exactly ``(0.0, 0.0)`` — the per-sample difference is identically
    zero, a useful self-test.
    """
    lp, lq = _mc_log_terms(
        cc_p, cc_q, store_p, store_q, num_samples, key, batch_size
    )
    if _support_violated(lq):
        return float("inf"), float("nan")
    d = lp - lq
    return float(d.mean()), float(d.std(ddof=1) / math.sqrt(len(d)))
