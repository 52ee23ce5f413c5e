"""Structural pruning of trained circuits: drop low-importance units.

An extension beyond the reference (which has no post-training compression).
Given a symbolic circuit and its trained parameter store, ``prune_circuit``
returns a NEW, smaller symbolic circuit whose layers keep only the
important units, with the trained values sliced in as constant (still
learnable) parameters — ready to re-compile for serving or fine-tuning
(plain weights, so the pruned circuit is ``fit_em``-eligible).

How it works:

1. **Readback.** The circuit is re-compiled *unoptimized + folded* through
   a sibling compiler sharing the context's parameter state, so every
   layer's materialized parameters (softmax weights applied, etc.) can be
   read straight out of the trained store at the layer's retained
   ``(plan entry, fold)`` placement (``JaxCircuit._symbolic_fold``) —
   the same slot-sharing mechanism the circuit product operator uses.
2. **Scoring.** A root-to-leaf max-product importance flow: the root units
   score 1; a sum sends each child unit ``max_o score_o * Wn[o, j]`` (rows
   normalized), products pass scores through (Kronecker: max over the
   composites a digit participates in). A unit's score upper-bounds the
   normalized weight of any mixture path using it.
3. **Kept-set fixpoint.** Units scoring >= ``threshold`` (or the top
   ``1 - fraction`` per layer) are kept, then constraints are repaired to
   a fixpoint: product layers need the SAME kept set as each child
   (elementwise/digit alignment); sum layers need EQUAL kept counts
   across children (the dense weight is (O, arity * K)) — smaller
   siblings grow back their next-best units. Output layers keep all.
4. **Rebuild.** New layers are constructed in topological order with the
   materialized values sliced to the kept units (Kronecker consumers remap
   composite columns; the surviving composites keep their true weights).

Pruning quality follows the classic flow/weight-magnitude heuristics
(Dang et al., "Pruning and growing probabilistic circuits"); the
``threshold=0`` setting is a lossless round-trip, which the tests pin
against the original distribution by enumeration.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from cirkit_tpu.symbolic.circuit import Circuit
from cirkit_tpu.symbolic.initializers import ConstantTensorInitializer
from cirkit_tpu.symbolic.layers import (
    BinomialLayer,
    CategoricalLayer,
    EmbeddingLayer,
    GaussianLayer,
    HadamardLayer,
    KroneckerLayer,
    Layer,
    SumLayer,
)
from cirkit_tpu.symbolic.parameters import Parameter, TensorParameter


def _const(value: np.ndarray) -> Parameter:
    return Parameter.from_input(
        TensorParameter(
            *value.shape,
            initializer=ConstantTensorInitializer(np.asarray(value)),
            learnable=True,
        )
    )


def _sibling_compile(sc: Circuit, ctx):
    """Unoptimized folded sibling compile sharing the context's compiler
    state (slots resolve to the SAME trained arrays): returns the compiled
    circuit and its retained symbolic-layer -> (plan entry, fold) map."""
    from cirkit_tpu.backend.jax.compiler import JaxCompiler

    base = ctx._compiler
    raw = JaxCompiler(semiring=base._flags["semiring"], fold=True, optimize=False)
    raw.state = base.state
    cc = raw.compile(sc)
    placement = cc._symbolic_fold
    assert placement is not None  # unoptimized compile always retains it
    return cc, placement


def _materialize(sc: Circuit, ctx, store, sib=None) -> dict[Layer, Any]:
    """Per-symbolic-layer materialized parameter values from the trained
    store, via an unoptimized folded sibling compile sharing the
    context's compiler state (slots resolve to the SAME trained arrays).
    Pass a precomputed ``sib = _sibling_compile(sc, ctx)`` to share the
    compile with other readback passes."""
    from cirkit_tpu.backend.jax.layers import (
        JaxBinomialLayer,
        JaxCategoricalLayer,
        JaxEmbeddingLayer,
        JaxGaussianLayer,
        JaxSumLayer,
    )

    if sib is None:
        sib = _sibling_compile(sc, ctx)
    cc, placement = sib
    import jax

    # Materialize each ENTRY's folded parameters once (slicing folds on
    # host: per-symbolic-layer pulls would repeat the program and transfer
    # F times), ALL entries in ONE jitted program: per-entry eager
    # evaluation would cost one compile per program.
    needed: dict[int, Any] = {}
    for sl, (pi, _f) in placement.items():
        jl = cc._entries[pi].layer
        if isinstance(sl, GaussianLayer):
            if isinstance(jl, JaxGaussianLayer) and jl.log_partition is not None:
                raise NotImplementedError(
                    "Pruning unnormalized (log-partition) Gaussian layers is "
                    "not supported"
                )
            needed[pi] = jl
        elif isinstance(sl, (SumLayer, CategoricalLayer, EmbeddingLayer, BinomialLayer)):
            needed[pi] = jl
        elif isinstance(sl, (HadamardLayer, KroneckerLayer)):
            pass  # parameterless
        else:
            raise NotImplementedError(
                f"Pruning is not supported for {type(sl).__name__}"
            )

    def eval_all(st):
        out: dict[int, Any] = {}
        for pi, jl in needed.items():
            if isinstance(jl, JaxGaussianLayer):
                out[pi] = (jl.mean(st), jl.stddev(st))
            elif isinstance(jl, JaxBinomialLayer):
                out[pi] = jax.nn.sigmoid(jl._logits(st))
            elif isinstance(jl, JaxCategoricalLayer):
                out[pi] = jl.state_distribution(st)
            else:  # sum-style / embedding weight
                out[pi] = jl.weight(st)
        return out

    dev = jax.jit(eval_all)(store)
    # NATIVE-dtype pulls: converting a multi-GB folded entry to f64 at
    # readback doubles the bytes and adds a GB-scale host astype.
    # Downstream slicing/scoring/rebuild is dtype-agnostic; under x64
    # tests the store is f64 already.
    entry_cache: dict[int, Any] = {}

    def entry_value(pi: int) -> Any:
        cached = entry_cache.get(pi)
        if cached is None:
            v = dev.pop(pi)  # free the device copy once pulled: peak HBM
            cached = (  # stays ~store-size, not store + materialized copy
                tuple(np.asarray(a) for a in v)
                if isinstance(v, tuple)
                else np.asarray(v)
            )
            entry_cache[pi] = cached
        return cached

    values: dict[Layer, Any] = {}
    for sl, (pi, f) in placement.items():
        if isinstance(sl, (SumLayer, CategoricalLayer, EmbeddingLayer, BinomialLayer)):
            values[sl] = entry_value(pi)[f]
        elif isinstance(sl, GaussianLayer):
            m, s = entry_value(pi)
            values[sl] = (m[f], s[f])
    return values


def _importance(
    sc: Circuit,
    values: dict[Layer, Any],
    topo: list[Layer],
    out_set: set[Layer],
    what: str,
) -> dict[Layer, np.ndarray]:
    """Root-to-leaf max-product importance flow: the root units score 1; a
    sum sends each child unit ``max_o score_o * Wn[o, j]`` (rows
    normalized), products pass scores through (Kronecker: max over the
    composites a digit participates in). A unit's score upper-bounds the
    normalized weight of any mixture path using it. Shared by pruning
    (drop low scores) and growing (duplicate high scores)."""
    score: dict[Layer, np.ndarray] = {
        sl: np.full(sl.num_output_units, -np.inf) for sl in topo
    }
    for sl in out_set:
        score[sl] = np.ones(sl.num_output_units)
    for sl in reversed(topo):
        s = score[sl]
        children = sc.layer_inputs(sl)
        if not children:
            continue
        if isinstance(sl, SumLayer):
            w = values[sl]  # (O, H*K), native store dtype
            if w.dtype.itemsize < 4:
                # bf16 stores: host-emulated 16-bit ufuncs are slow and the
                # accumulation error can reorder ranks near the threshold;
                # score in f32 (per-fold 2-D slices are small vs readback).
                w = np.asarray(w, np.float32)
            z = np.maximum(w.sum(axis=1, keepdims=True), np.finfo(w.dtype).tiny)
            contrib = (s[:, None] * (w / z)).max(axis=0)  # (H*K,)
            k = sl.num_input_units
            for h, c in enumerate(children):
                score[c] = np.maximum(score[c], contrib[h * k : (h + 1) * k])
        elif isinstance(sl, HadamardLayer):
            for c in children:
                score[c] = np.maximum(score[c], s)
        elif isinstance(sl, KroneckerLayer):
            k, h = sl.num_input_units, sl.arity
            cube = s.reshape((k,) * h)
            for hh, c in enumerate(children):
                axes = tuple(a for a in range(h) if a != hh)
                score[c] = np.maximum(score[c], cube.max(axis=axes) if axes else cube)
        else:
            raise NotImplementedError(
                f"{what} is not supported for {type(sl).__name__}"
            )
    return score


def _flow_importance(
    sc: Circuit,
    ctx,
    store,
    data,
    batch_size: int,
    sib=None,
) -> dict[Layer, np.ndarray]:
    """Data-aware importance: each unit's average expected posterior usage
    over ``data`` — the gradient of the mean evidence log-likelihood with
    respect to a zero additive offset on EVERY layer's log-output (the same
    flow identity EM's E-step and ExpectationQuery use, applied to inner
    layers too). This is the criterion of Dang et al.'s circuit pruning
    (expected flows), where :func:`_importance` is its data-free
    weight-magnitude upper bound: units on parses the data never activates
    score ~0 regardless of their weights. Works for ANY weight
    parameterization (softmax included) — the offsets sit on outputs, not
    parameters."""
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.layers import JaxConstantInputLayer
    from cirkit_tpu.backend.jax.semiring import LSESumSemiring

    if sib is None:
        sib = _sibling_compile(sc, ctx)
    cc, placement = sib
    if cc.semiring is not LSESumSemiring:
        raise NotImplementedError(
            "Flow-based importance requires the 'lse-sum' semiring"
        )
    store = cc.restrict_store(store)
    entries = [
        (e, entry.layer)
        for e, entry in enumerate(cc._entries)
        if not isinstance(entry.layer, JaxConstantInputLayer)
    ]
    off_name = {id(layer): f"__f{e}" for e, layer in entries}

    def run(st, offs, xx, ww):
        def total_ll(o):
            def fn(layer, s, xin):
                out = layer(s, xin)
                name = off_name.get(id(layer))
                return out if name is None else out + o[name]

            # every root head seeds flow 1, matching _importance; ww
            # zeroes the repeated rows a padded final batch carries
            return jnp.sum(cc.evaluate(st, xx, module_fn=fn) * ww[:, None, None])

        # reduce the batch axis INSIDE the program: per-entry eager sums
        # would each cost a separate compile plus a dispatch per batch, and
        # the pulls shrink from (F,B,O) sums to (F,O) results
        return jax.tree_util.tree_map(
            lambda g: jnp.sum(g, axis=1), jax.grad(total_ll)(offs)
        )

    run_jit = jax.jit(run)
    data = np.asarray(data)
    # 32-bit batches, converted once on the host (same policy as
    # fit()/fit_em)
    if not jax.config.jax_enable_x64:
        if data.dtype == np.int64:
            data = data.astype(np.int32)
        elif data.dtype == np.float64:
            data = data.astype(np.float32)
    acc = {
        f"__f{e}": np.zeros((layer.num_folds, layer.num_output_units))
        for e, layer in entries
    }
    dt = jnp.result_type(float)
    n = data.shape[0]
    for lo in range(0, n, batch_size):
        xb = data[lo : lo + batch_size]
        ww = np.ones(xb.shape[0], dtype=np.float32)
        if xb.shape[0] < batch_size and lo > 0:
            # zero-weight pad keeps one compiled program across batches
            pad = batch_size - xb.shape[0]
            xb = np.concatenate([xb, np.broadcast_to(xb[:1], (pad, *xb.shape[1:]))])
            ww = np.concatenate([ww, np.zeros(pad, dtype=np.float32)])
        offs = {
            f"__f{e}": jnp.zeros((layer.num_folds, xb.shape[0], layer.num_output_units), dt)
            for e, layer in entries
        }
        grads = run_jit(store, offs, jnp.asarray(xb), jnp.asarray(ww))
        for g in grads.values():  # overlap the per-entry readbacks
            if hasattr(g, "copy_to_host_async"):
                g.copy_to_host_async()
        for name, g in grads.items():
            acc[name] += np.asarray(g, np.float64)
    score: dict[Layer, np.ndarray] = {}
    for sl, (pi, f) in placement.items():
        name = f"__f{pi}"
        if name in acc:
            score[sl] = acc[name][f] / n
    return score


def prune_circuit(
    sc: Circuit,
    *,
    ctx,
    store=None,
    threshold: float | None = None,
    fraction: float | None = None,
    min_units: int = 1,
    data=None,
    batch_size: int = 1024,
) -> tuple[Circuit, dict]:
    """Prune low-importance units from a trained circuit.

    Exactly one of ``threshold`` (keep units whose importance is >= it) or
    ``fraction`` (prune this fraction of each prunable layer's units,
    lowest importance first) must be given. ``store`` defaults to the
    context's parameters (merged over them otherwise). Returns
    ``(pruned symbolic circuit, report)`` where the report carries
    per-layer kept counts and the total unit/parameter reduction.
    ``threshold=0.0`` is a lossless rebuild (pinned in tests).

    Importance is the data-free root-to-leaf max-product weight flow by
    default; pass ``data`` (a (N, D) array) to score by **expected
    posterior usage flows** instead — Dang et al.'s criterion: each
    unit's average responsibility over the dataset (one forward+backward
    per batch), so units the data never routes through are pruned even
    when their weights are large. With ``data``, ``threshold`` is in
    average-usage units (e.g. ``1e-4`` = used by ~0.01% of parses).
    """
    if (threshold is None) == (fraction is None):
        raise ValueError("Exactly one of 'threshold' and 'fraction' must be given")
    if not ctx._compiler.is_compiled(sc):
        raise ValueError(
            "Compile the circuit through this context first (ctx.compile(sc)): "
            "pruning reads the trained parameters back through the context's "
            "slot state"
        )
    full = dict(ctx.parameters)
    if store is not None:
        full.update(store)
    sib = _sibling_compile(sc, ctx)
    values = _materialize(sc, ctx, full, sib=sib)

    topo = list(sc.topological_ordering())
    out_set = set(sc.outputs)
    if data is not None:
        score = _flow_importance(sc, ctx, full, data, batch_size, sib=sib)
        for sl in out_set:
            score[sl] = np.ones(sl.num_output_units)
    else:
        score = _importance(sc, values, topo, out_set, "Pruning")

    # ---- initial kept sets --------------------------------------------------
    # Boolean masks, not Python sets: the flagship fixpoint walks ~2600
    # layers with 4096-wide Kronecker composites — set arithmetic there is
    # minutes of pure interpreter time, mask ops are vectorized.
    kept: dict[Layer, np.ndarray] = {}
    order: dict[Layer, np.ndarray] = {}
    for sl in topo:
        rank = np.argsort(-score[sl], kind="stable")
        order[sl] = rank
        m = np.zeros(sl.num_output_units, dtype=bool)
        if sl in out_set:
            m[:] = True
        elif isinstance(sl, KroneckerLayer):
            # composites are DERIVED (cross product of the children's kept
            # units, filled by the fixpoint): thresholding composites
            # directly is self-defeating — the top composites' digit
            # unions typically cover every digit and the closure grows
            # back to the full layer
            pass
        elif threshold is not None:
            m = score[sl] >= threshold
            if int(m.sum()) < min_units:
                m[:] = False
                m[rank[:min_units]] = True
        else:
            n = max(min_units, math.ceil(sl.num_output_units * (1.0 - fraction)))
            m[rank[:n]] = True
        kept[sl] = m

    # ---- fixpoint repair of structural constraints --------------------------
    changed = True
    while changed:
        changed = False
        for sl in reversed(topo):
            children = sc.layer_inputs(sl)
            if isinstance(sl, HadamardLayer):
                u = kept[sl].copy()
                for c in children:
                    u |= kept[c]
                for lay in (sl, *children):
                    if not np.array_equal(kept[lay], u):
                        kept[lay] = u.copy()
                        changed = True
            elif isinstance(sl, KroneckerLayer):
                k, h = sl.num_input_units, sl.arity
                cube = kept[sl].reshape((k,) * h)
                for hh, c in enumerate(children):
                    axes = tuple(a for a in range(h) if a != hh)
                    u = kept[c] | (cube.any(axis=axes) if axes else cube)
                    if not np.array_equal(kept[c], u):
                        kept[c] = u
                        changed = True
                # the new layer computes the cross product of kept digits
                # (first operand most significant, row-major)
                # copy: for arity 1 `comp` would alias the child's mask, and
                # the SumLayer equalize branch mutates masks in place below
                comp = kept[children[0]].copy()
                for c in children[1:]:
                    comp = (comp[:, None] & kept[c][None, :]).reshape(-1)
                if not np.array_equal(kept[sl], comp):
                    kept[sl] = comp
                    changed = True
            elif isinstance(sl, SumLayer) and children:
                target = max(int(kept[c].sum()) for c in children)
                for c in children:
                    have = int(kept[c].sum())
                    if have < target:
                        # grow back the next-best units by score order
                        ranked = order[c]
                        extra = ranked[~kept[c][ranked]][: target - have]
                        kept[c][extra] = True
                        changed = True

    # ---- rebuild ------------------------------------------------------------
    # old_index[layer]: new unit position -> old unit index (int array)
    old_index: dict[Layer, np.ndarray] = {}
    new_layers: dict[Layer, Layer] = {}
    in_map: dict[Layer, list[Layer]] = {}
    for sl in topo:
        children = sc.layer_inputs(sl)
        if isinstance(sl, KroneckerLayer):
            k, h = sl.num_input_units, sl.arity
            idx = np.zeros(1, dtype=np.int64)
            for c in children:
                idx = (idx[:, None] * k + old_index[c][None, :]).reshape(-1)
            old_index[sl] = idx
            nk = len(old_index[children[0]])
            new_layers[sl] = KroneckerLayer(nk, arity=h)
        elif isinstance(sl, HadamardLayer):
            old_index[sl] = old_index[children[0]]
            new_layers[sl] = HadamardLayer(len(old_index[sl]), arity=sl.arity)
        elif isinstance(sl, SumLayer):
            rows = np.flatnonzero(kept[sl])
            old_index[sl] = rows
            w = values[sl]
            k = sl.num_input_units
            widths = {len(old_index[c]) for c in children}
            if len(widths) != 1:
                # a Kronecker sibling can only take cross-product widths a
                # dense sibling may be unable to match — cf. the fixpoint
                raise NotImplementedError(
                    "Pruning could not equalize the input widths of a sum "
                    f"layer (got {sorted(widths)}); use a smaller fraction"
                )
            cols = np.concatenate(
                [h * k + old_index[c] for h, c in enumerate(children)]
            )
            new_w = w[np.ix_(rows, cols)]
            nk = len(old_index[children[0]])
            new_layers[sl] = SumLayer(nk, len(rows), arity=sl.arity, weight=_const(new_w))
        else:  # input layers
            rows = np.flatnonzero(kept[sl])
            old_index[sl] = rows
            if isinstance(sl, CategoricalLayer):
                new_layers[sl] = CategoricalLayer(
                    sl.scope, len(rows), num_categories=sl.num_categories,
                    probs=_const(values[sl][rows]),
                )
            elif isinstance(sl, GaussianLayer):
                m, s = values[sl]
                new_layers[sl] = GaussianLayer(
                    sl.scope, len(rows), mean=_const(m[rows]), stddev=_const(s[rows])
                )
            elif isinstance(sl, BinomialLayer):
                new_layers[sl] = BinomialLayer(
                    sl.scope, len(rows), total_count=sl.total_count,
                    probs=_const(values[sl][rows]),
                )
            else:  # EmbeddingLayer
                new_layers[sl] = EmbeddingLayer(
                    sl.scope, len(rows), num_states=sl.num_states,
                    weight=_const(values[sl][rows]),
                )
        if children:
            in_map[new_layers[sl]] = [new_layers[c] for c in children]

    pruned = Circuit(
        [new_layers[sl] for sl in topo], in_map, [new_layers[o] for o in sc.outputs]
    )
    units_before = sum(sl.num_output_units for sl in topo)
    units_after = sum(l.num_output_units for l in new_layers.values())
    report = {
        "units_before": units_before,
        "units_after": units_after,
        "per_layer": [
            (type(sl).__name__, sl.num_output_units, new_layers[sl].num_output_units)
            for sl in topo
        ],
    }
    return pruned, report


def _gather_list(mult: np.ndarray) -> np.ndarray:
    """New-unit -> original-unit gather for a multiplicity vector:
    ``[0, 0, 1, 2]`` for ``mult = [2, 1, 1]`` (copies adjacent, stable
    order — all Hadamard siblings share one mult, hence one gather)."""
    return np.repeat(np.arange(len(mult)), mult)


def grow_circuit(
    sc: Circuit,
    *,
    ctx,
    store=None,
    fraction: float = 0.25,
    noise: float = 0.1,
    seed: int = 0,
    data=None,
    batch_size: int = 1024,
) -> tuple[Circuit, dict]:
    """Grow a trained circuit: duplicate its most important units.

    Pass ``data`` to rank units by expected posterior usage flows over the
    dataset instead of the data-free weight flow (see
    :func:`prune_circuit`) — growth then targets the units the data
    actually routes through (the overloaded mixture components).

    The structural inverse of :func:`prune_circuit` and the other half of
    the grow/prune structure-learning loop (Dang et al., "Pruning and
    growing probabilistic circuits"): per prunable layer, the top
    ``fraction`` of units by the same root-to-leaf max-product importance
    flow get a second copy. Copies start as exact clones with each
    consumer's incoming weight split uniformly over them, so ``noise=0``
    is EXACTLY distribution-preserving (pinned in tests); ``noise > 0``
    applies multiplicative jitter to the copies (leaf rows, duplicated
    sum rows) to break the symmetry so EM/SGD fine-tuning can
    differentiate them. Structural constraints are repaired to a
    fixpoint like pruning's kept sets: Hadamard layers and their
    children share one multiplicity vector (elementwise max), Kronecker
    composites DERIVE from their digits (children equalized to one
    width), sum children are equalized by duplicating their next-best
    units. Output layers keep their unit count (the interface).

    Returns ``(grown symbolic circuit, report)``. The grown circuit's
    parameters are plain constant (still learnable) slots, so it is
    ``fit_em``-eligible — the intended next step.

    Choosing ``noise``: near-identical copies are an EM *saddle* — with
    tiny jitter the responsibilities stay near-equal and differentiation
    takes many epochs (measured: noise 0.3 barely moved a mixture fit in
    60 epochs where 0.8 converged in 25). For grow-then-EM use noise in
    the 0.1-1.0 range (it is a multiplicative log-scale jitter on the
    copies only, so the pre-fine-tune distribution stays close); use 0.0
    only when an exactly distribution-preserving rebuild is the point.
    """
    if not 0.0 < fraction <= 1.0:
        raise ValueError("'fraction' must be in (0, 1]")
    if noise < 0.0:
        raise ValueError("'noise' must be nonnegative")
    if not ctx._compiler.is_compiled(sc):
        raise ValueError(
            "Compile the circuit through this context first (ctx.compile(sc)): "
            "growing reads the trained parameters back through the context's "
            "slot state"
        )
    full = dict(ctx.parameters)
    if store is not None:
        full.update(store)
    sib = _sibling_compile(sc, ctx)
    values = _materialize(sc, ctx, full, sib=sib)
    topo = list(sc.topological_ordering())
    out_set = set(sc.outputs)
    if data is not None:
        score = _flow_importance(sc, ctx, full, data, batch_size, sib=sib)
        for sl in out_set:
            score[sl] = np.ones(sl.num_output_units)
    else:
        score = _importance(sc, values, topo, out_set, "Growing")
    rng = np.random.default_rng(seed)

    # ---- initial multiplicities: +1 copy for the top-scored units -----------
    mult: dict[Layer, np.ndarray] = {}
    order: dict[Layer, np.ndarray] = {}
    for sl in topo:
        k = sl.num_output_units
        order[sl] = np.argsort(-score[sl], kind="stable")
        m = np.ones(k, dtype=int)
        if sl not in out_set and not isinstance(sl, (HadamardLayer, KroneckerLayer)):
            n = max(1, math.ceil(k * fraction))
            m[order[sl][:n]] += 1
        mult[sl] = m

    # ---- fixpoint repair of structural constraints --------------------------
    def _equalize(children: list[Layer], target: int) -> bool:
        changed = False
        for c in children:
            if isinstance(c, KroneckerLayer):
                if int(mult[c].sum()) != target:
                    raise NotImplementedError(
                        "Growing could not equalize a Kronecker sibling's "
                        "width (cross-product widths cannot grow by one); "
                        "use a template without mixed dense/Kronecker "
                        "sum inputs"
                    )
                continue
            while int(mult[c].sum()) < target:
                for j in order[c]:
                    if int(mult[c].sum()) >= target:
                        break
                    mult[c][int(j)] += 1
                changed = True
        return changed

    for _ in range(100):
        changed = False
        for sl in reversed(topo):
            children = sc.layer_inputs(sl)
            if isinstance(sl, HadamardLayer):
                m = mult[sl]
                for c in children:
                    m = np.maximum(m, mult[c])
                for lay in (sl, *children):
                    if not np.array_equal(mult[lay], m):
                        mult[lay] = m.copy()
                        changed = True
            elif isinstance(sl, KroneckerLayer):
                # children must share one width; composites derive from digits
                target = max(int(mult[c].sum()) for c in children)
                changed |= _equalize(list(children), target)
                comp = np.ones(1, dtype=int)
                for c in children:  # first child most significant
                    comp = np.kron(comp, mult[c])
                if not np.array_equal(mult[sl], comp):
                    mult[sl] = comp
                    changed = True
            elif isinstance(sl, SumLayer) and children:
                target = max(int(mult[c].sum()) for c in children)
                changed |= _equalize(list(children), target)
        if not changed:
            break
    else:
        raise NotImplementedError("Growing did not reach a structural fixpoint")

    # ---- rebuild -------------------------------------------------------------
    def _jitter(rows: np.ndarray, gather: list[int]) -> np.ndarray:
        """1 for the first occurrence of each original unit, exp(noise *
        eps) for later copies — multiplicative symmetry breaking."""
        fac = np.ones(rows.shape)
        seen: set[int] = set()
        for i, j in enumerate(gather):
            if j in seen and noise > 0.0:
                fac[i] = np.exp(noise * rng.standard_normal(rows.shape[1:]))
            seen.add(j)
        return fac

    gather: dict[Layer, np.ndarray] = {}
    new_layers: dict[Layer, Layer] = {}
    in_map: dict[Layer, list[Layer]] = {}
    for sl in topo:
        children = sc.layer_inputs(sl)
        if isinstance(sl, KroneckerLayer):
            k = sl.num_input_units
            idx = np.zeros(1, dtype=np.int64)
            for c in children:
                idx = (idx[:, None] * k + gather[c][None, :]).reshape(-1)
            gather[sl] = idx
            new_layers[sl] = KroneckerLayer(len(gather[children[0]]), arity=sl.arity)
        elif isinstance(sl, HadamardLayer):
            gather[sl] = _gather_list(mult[sl])
            new_layers[sl] = HadamardLayer(len(gather[sl]), arity=sl.arity)
        elif isinstance(sl, SumLayer):
            g = _gather_list(mult[sl]) if sl not in out_set else np.arange(
                sl.num_output_units
            )
            gather[sl] = g
            w = values[sl]
            k = sl.num_input_units
            widths = {len(gather[c]) for c in children}
            if len(widths) != 1:
                raise NotImplementedError(
                    "Growing could not equalize the input widths of a sum "
                    f"layer (got {sorted(widths)})"
                )
            cols, splits = [], []
            for h, c in enumerate(children):
                cnt = np.bincount(gather[c], minlength=c.num_output_units)
                cols.append(h * k + gather[c])
                splits.append(1.0 / cnt[gather[c]])
            new_w = w[np.ix_(g, np.concatenate(cols))] * np.concatenate(splits)[None, :]
            new_w = new_w * _jitter(new_w, g)
            nk = len(gather[children[0]])
            new_layers[sl] = SumLayer(nk, len(g), arity=sl.arity, weight=_const(new_w))
        else:  # input layers
            g = _gather_list(mult[sl]) if sl not in out_set else np.arange(
                sl.num_output_units
            )
            gather[sl] = g
            if isinstance(sl, CategoricalLayer):
                p = values[sl][g] * _jitter(values[sl][g], g)
                p = p / np.maximum(p.sum(axis=1, keepdims=True), np.finfo(np.float64).tiny)
                new_layers[sl] = CategoricalLayer(
                    sl.scope, len(g), num_categories=sl.num_categories,
                    probs=_const(p),
                )
            elif isinstance(sl, GaussianLayer):
                m, s = values[sl]
                m, s = m[g].copy(), s[g].copy()
                seen: set[int] = set()
                for i, j in enumerate(g):
                    if j in seen and noise > 0.0:
                        m[i] += noise * s[i] * rng.standard_normal()
                    seen.add(j)
                new_layers[sl] = GaussianLayer(
                    sl.scope, len(g), mean=_const(m), stddev=_const(s)
                )
            elif isinstance(sl, BinomialLayer):
                p = values[sl][g].copy()
                seen = set()
                for i, j in enumerate(g):
                    if j in seen and noise > 0.0:
                        logit = np.log(p[i]) - np.log1p(-p[i])
                        p[i] = 1.0 / (1.0 + np.exp(-(logit + noise * rng.standard_normal())))
                    seen.add(j)
                new_layers[sl] = BinomialLayer(
                    sl.scope, len(g), total_count=sl.total_count, probs=_const(p)
                )
            else:  # EmbeddingLayer
                t = values[sl][g] * _jitter(values[sl][g], g)
                new_layers[sl] = EmbeddingLayer(
                    sl.scope, len(g), num_states=sl.num_states, weight=_const(t)
                )
        if children:
            in_map[new_layers[sl]] = [new_layers[c] for c in children]

    grown = Circuit(
        [new_layers[sl] for sl in topo], in_map, [new_layers[o] for o in sc.outputs]
    )
    units_before = sum(sl.num_output_units for sl in topo)
    units_after = sum(l.num_output_units for l in new_layers.values())
    report = {
        "units_before": units_before,
        "units_after": units_after,
        "per_layer": [
            (type(sl).__name__, sl.num_output_units, new_layers[sl].num_output_units)
            for sl in topo
        ],
    }
    return grown, report


def selection_score(
    mean_ll: float, num_params: int, n: int, criterion: str = "ll"
) -> float:
    """Model-selection score (maximize) used by :func:`grow_prune_loop`.

    ``"ll"`` returns the mean log-likelihood unchanged; ``"aic"`` returns
    ``n·mean_ll − k`` (AIC/−2) and ``"bic"`` returns
    ``n·mean_ll − (k/2)·ln n`` (BIC/−2), so all three orders are
    comparable maximize-is-better. ``k`` is
    :attr:`Circuit.num_parameters` — raw learnable tensor entries."""
    if criterion == "ll":
        return mean_ll
    total = mean_ll * n
    if criterion == "aic":
        return total - num_params
    if criterion == "bic":
        return total - 0.5 * num_params * math.log(n)
    raise ValueError(f"Unknown criterion {criterion!r}; use 'll'|'bic'|'aic'")


def grow_prune_loop(
    sc: Circuit,
    data,
    *,
    ctx=None,
    val_data=None,
    rounds: int = 3,
    grow_fraction: float = 0.25,
    prune_fraction: float = 0.2,
    noise: float = 0.5,
    em_epochs: int = 10,
    batch_size: int = 1024,
    seed: int = 0,
    verbose: bool = False,
    ctx_factory=None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    criterion: str = "ll",
):
    """The full grow/prune structure-learning loop (Dang et al., "Pruning
    and growing probabilistic circuits"), orchestrating this module's
    pieces end to end: per round, GROW ``grow_fraction`` of each layer's
    units by duplicating the most-used ones (with ``noise`` jitter so EM
    can differentiate the copies), EM-train, then PRUNE the
    ``prune_fraction`` with the least expected usage on ``data``
    (reallocating capacity away from parses the data never takes), and EM
    again. Equal fractions keep net size roughly constant while the
    structure adapts; ``grow_fraction > prune_fraction`` searches upward
    in capacity (the default). Keeps the best (circuit, store) by
    held-out log-likelihood on ``val_data`` (``data`` itself if not
    given) and stops early when a full round fails to improve it.

    ``criterion`` selects the model-selection score (maximized):

    - ``"ll"`` (default) — mean held-out log-likelihood, Dang et al.'s
      setup (use ``val_data`` to avoid favoring capacity).
    - ``"bic"`` — total LL − (k/2)·ln n over the selection set, where
      ``k = circuit.num_parameters`` and ``n = len(val_data or data)``:
      the Bayesian information criterion (rescaled by −1/2 so bigger is
      better). Penalizes capacity, so train-set-only searches
      (no ``val_data``) stay honest.
    - ``"aic"`` — total LL − k (Akaike, same rescaling); a lighter
      capacity penalty than BIC for ``n > e²``.

    BIC/AIC count raw learnable tensor entries (softmax rows are not
    reduced by one dof) — constant-offset consistent across candidates.

    The input circuit must be ``fit_em``-eligible (plain sum weights and
    leaves — e.g. templates built with ``em_ready=True``); pruned/grown
    rebuilds are plain by construction. Returns ``(best symbolic circuit,
    best trained store, history)`` where history rows are
    ``(stage, units, heldout_ll)``.

    ``checkpoint_dir`` persists the loop state after every completed stage
    (current + best symbolic circuits via ``save_circuit``, their trained
    stores, the history, and an atomically-replaced LATEST marker);
    ``resume=True`` restores the newest stage and continues — a structure
    search killed mid-way redoes at most one stage. Deterministic given
    the same data/fractions/seed (stage seeds derive from the round
    index), so a resumed run reproduces the uninterrupted one.
    """
    from cirkit_tpu.parallel import evaluate_ll, fit_em
    from cirkit_tpu.pipeline import PipelineContext

    if ctx is None:
        ctx = PipelineContext(semiring="lse-sum", fold=True)
    if ctx_factory is None:
        # clone the input context's backend flags for each stage; a fresh
        # context per stage keeps the returned (circuit, store) pair
        # portable — slot names allocate deterministically per compile
        # order, so a later fresh compile of best_sc accepts best_store.
        # Custom per-context optimization rules do NOT carry over: pass
        # ctx_factory to recreate them per stage.
        def ctx_factory():
            return PipelineContext(ctx._backend, **ctx._backend_kwargs)

    if criterion not in ("ll", "bic", "aic"):
        raise ValueError(f"Unknown criterion {criterion!r}; use 'll'|'bic'|'aic'")
    val = data if val_data is None else val_data
    n_val = len(val)

    def units_of(s: Circuit) -> int:
        return sum(sl.num_output_units for sl in s.topological_ordering())

    def score_of(s: Circuit, mean_ll: float) -> float:
        return selection_score(mean_ll, s.num_parameters, n_val, criterion)

    def train(s: Circuit, c):
        cc = c.compile(s)
        store, _ = fit_em(
            cc, data, store=dict(c.parameters), num_epochs=em_epochs,
            batch_size=batch_size,
        )
        c.parameters.update(store)
        ll = float(evaluate_ll(cc, val, store=store))
        return cc, store, ll, score_of(s, ll)

    import json
    import logging
    import os
    import shutil

    log = logging.getLogger(__name__)

    def _link_or_copy(src: str, dst: str) -> None:
        try:
            os.link(src, dst)
        except OSError:  # cross-device / unsupported: fall back to a copy
            shutil.copyfile(src, dst)

    def _checkpoint(stages_done: int, improved: bool, best_is_cur: bool) -> None:
        if checkpoint_dir is None:
            return
        from cirkit_tpu.utils.checkpoint import save_circuit, save_store

        prev_dirs = [
            os.path.join(checkpoint_dir, name)
            for name in (
                os.listdir(checkpoint_dir) if os.path.isdir(checkpoint_dir) else []
            )
            if name.startswith("stage") and name != f"stage{stages_done}"
        ]
        sdir = os.path.join(checkpoint_dir, f"stage{stages_done}")
        os.makedirs(sdir, exist_ok=True)
        save_circuit(os.path.join(sdir, "cur_circuit.ckpt"), cur_sc)
        save_store(os.path.join(sdir, "cur_store.npz"), cur_store)
        # best artifacts: stores are large at structure-search scale, so
        # avoid re-serializing an unchanged best — hard-link the cur files
        # when best IS cur (it just improved), or the previous stage dir's
        # best files (still on disk; cleanup runs after) when it didn't
        prev_best = os.path.join(prev_dirs[0], "best_circuit.ckpt") if prev_dirs else ""
        if best_is_cur:
            _link_or_copy(
                os.path.join(sdir, "cur_circuit.ckpt"),
                os.path.join(sdir, "best_circuit.ckpt"),
            )
            _link_or_copy(
                os.path.join(sdir, "cur_store.npz"),
                os.path.join(sdir, "best_store.npz"),
            )
        elif prev_dirs and os.path.exists(prev_best):
            _link_or_copy(prev_best, os.path.join(sdir, "best_circuit.ckpt"))
            _link_or_copy(
                os.path.join(prev_dirs[0], "best_store.npz"),
                os.path.join(sdir, "best_store.npz"),
            )
        else:
            save_circuit(os.path.join(sdir, "best_circuit.ckpt"), best[0])
            save_store(os.path.join(sdir, "best_store.npz"), best[1])
        with open(os.path.join(sdir, "state.json"), "w") as fh:
            json.dump(
                {
                    "stages_done": stages_done,
                    "improved": improved,
                    "best_ll": best[2],
                    "best_score": best[3],
                    "criterion": criterion,
                    "history": history,
                },
                fh,
            )
        # the atomically-replaced marker is what makes a stage dir valid:
        # a kill mid-write leaves LATEST pointing at the previous stage
        tmp = os.path.join(checkpoint_dir, "LATEST.tmp")
        with open(tmp, "w") as fh:
            fh.write(str(stages_done))
        os.replace(tmp, os.path.join(checkpoint_dir, "LATEST"))
        for name in os.listdir(checkpoint_dir):
            if name.startswith("stage") and name != f"stage{stages_done}":
                shutil.rmtree(os.path.join(checkpoint_dir, name), ignore_errors=True)

    start_stages = 0
    improved_resume = False
    latest = (
        os.path.join(checkpoint_dir, "LATEST") if checkpoint_dir is not None else None
    )
    if resume and latest is not None and os.path.exists(latest):
        from cirkit_tpu.utils.checkpoint import load_circuit, load_store

        with open(latest) as fh:
            start_stages = int(fh.read().strip())
        sdir = os.path.join(checkpoint_dir, f"stage{start_stages}")
        with open(os.path.join(sdir, "state.json")) as fh:
            state = json.load(fh)
        improved_resume = bool(state["improved"])
        history = [tuple(row) for row in state["history"]]
        cur_sc = load_circuit(os.path.join(sdir, "cur_circuit.ckpt"))
        cur_store = load_store(os.path.join(sdir, "cur_store.npz"))
        if state.get("criterion", "ll") != criterion:
            raise ValueError(
                f"resume criterion mismatch: checkpoint used "
                f"{state.get('criterion', 'll')!r}, requested {criterion!r}"
            )
        best = (
            load_circuit(os.path.join(sdir, "best_circuit.ckpt")),
            load_store(os.path.join(sdir, "best_store.npz")),
            float(state["best_ll"]),
            float(state.get("best_score", state["best_ll"])),
        )
        cur_ctx = ctx_factory()
        cur_ctx.compile(cur_sc)  # slot names allocate deterministically
        cur_ctx.parameters.update(cur_store)
        if verbose:  # pragma: no cover - logging only
            log.info(
                "grow_prune_loop resume: %d stage(s) done, best LL %.4f",
                start_stages, best[2],
            )
    else:
        cc, store, ll, sc_score = train(sc, ctx)
        best = (sc, dict(store), ll, sc_score)
        cur_store = store
        history = [("init", units_of(sc), ll)]
        cur_sc, cur_ctx = sc, ctx
        _checkpoint(1, False, best_is_cur=True)
        start_stages = 1
        if verbose:  # pragma: no cover - logging only
            log.info("grow_prune_loop init: %d units, LL %.4f", units_of(sc), ll)

    idx = 1  # global stage counter; init is stage 1
    for r in range(rounds):
        if idx + 2 <= start_stages:
            idx += 2
            if idx == start_stages and not improved_resume:
                # the checkpointed run finished this round without improving
                # and early-stopped — replay the stop, don't run extra rounds
                break
            # otherwise a fully-completed, non-final round must have improved
            # (the original run would have stopped here if not)
            continue
        improved = improved_resume if idx < start_stages else False
        for stage in ("grow", "prune"):
            idx += 1
            if idx <= start_stages:
                continue
            if stage == "prune":
                if prune_fraction <= 0.0:
                    continue
                nxt, _rep = prune_circuit(
                    cur_sc, ctx=cur_ctx, fraction=prune_fraction, data=data,
                    batch_size=batch_size,
                )
            else:
                if grow_fraction <= 0.0:
                    continue
                nxt, _rep = grow_circuit(
                    cur_sc, ctx=cur_ctx, fraction=grow_fraction, noise=noise,
                    seed=seed + r, data=data, batch_size=batch_size,
                )
            nctx = ctx_factory()
            _, nstore, nll, nscore = train(nxt, nctx)
            history.append((f"{stage}@{r}", units_of(nxt), nll))
            if verbose:  # pragma: no cover
                log.info(
                    "grow_prune_loop %s@%d: %d units, LL %.4f",
                    stage, r, units_of(nxt), nll,
                )
            cur_sc, cur_ctx = nxt, nctx
            cur_store = nstore
            stage_improved = nscore > best[3]
            if stage_improved:
                best = (nxt, dict(nstore), nll, nscore)
                improved = True
            _checkpoint(idx, improved, best_is_cur=stage_improved)
        if not improved:
            break
    return best[0], best[1], history
