"""Expectation-maximization training for monotonic circuits.

EM is the classic PC parameter estimator (Peharz et al., "Einsum networks",
2020): each sum unit is a latent mixture, the E-step computes **expected
flows** — the expected number of times each mixture edge is used under the
posterior — and the M-step sets the weights proportional to them. Neither
the reference nor its notebooks implement EM (training is user-land SGD,
SURVEY.md §3.5); this module is an extension.

The flow trick makes the E-step one backward pass: for a normalized circuit
with *plain* (unreparameterized) weight tensors, the expected flow of edge
``(o, i)`` over a batch is ``w[o, i] * d/dw[o, i] sum_b log p(x_b)``. The
M-step renormalizes flows along each unit's mixture axis, so weights stay
nonnegative and normalized by construction — no projection, no learning
rate, and full-batch EM increases the likelihood monotonically.

Requirements, checked at build time:

- sum-style weights (dense/mixing/fused Tucker/CPT) must be **plain slots**
  (or a slot feeding a MixingWeight block-diagonal placement, whose 0/1
  structure preserves the flow identity). Build templates with
  ``Parameterization(activation="none", initialization="dirichlet")``.
- categorical input layers update when parameterized by plain ``probs``.
- Gaussian input layers update when mean AND stddev are plain slots: the
  unit responsibilities come from the gradient of the log-likelihood with
  respect to a zero additive offset on each unit's log-output (that
  derivative *is* the expected count), and the weighted sufficient
  statistics are recovered in closed form from the mean/stddev gradients —
  no extra passes.
- Binomial input layers update when parameterized by a plain ``probs`` or
  ``logits`` slot, via the same offset-gradient responsibilities and the
  closed-form success-probability update.
- other input parameters (embeddings, polynomial coefficients, ...) are
  left fixed — combine EM for the rest with :func:`fit`.
"""

from __future__ import annotations

import warnings
from collections.abc import Callable

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.circuit import JaxCircuit
from cirkit_tpu.backend.jax.layers import (
    JaxBinomialLayer,
    JaxCategoricalLayer,
    JaxGaussianLayer,
    JaxSumLayer,
)
from cirkit_tpu.backend.jax.optimized import (
    JaxCPTLayer,
    JaxTensorDotLayer,
    JaxTuckerLayer,
)
from cirkit_tpu.backend.jax.parameters import (
    JaxMatMulParameter,
    JaxMixingWeightParameter,
    JaxParameter,
    JaxPointerSlot,
    JaxTensorSlot,
    Store,
)

# Store reads inside a weight graph: a slot's own tensor, or a POINTER to a
# slot allocated elsewhere (parameter sharing — operator-derived circuits
# such as `mixture` ensembles, and `ref()`-tied weights). Flows computed as
# ``theta * dLL/dtheta`` on the *underlying store entry* are exact through
# any pointer gather (the gather is 0/1-linear, and autodiff accumulates
# the per-use partials), so EM on a derived circuit trains the shared
# parameters — the tied-multinomial M-step (normalize the SUMMED expected
# counts across uses).
_SLOT_READS = (JaxTensorSlot, JaxPointerSlot)


def _flow_slot(param: JaxParameter) -> str | None:
    """The store slot behind a weight, if the parameter graph preserves the
    flow identity ``flows = theta * dLL/dtheta``: a bare slot read, or a
    slot feeding a MixingWeight 0/1 placement."""
    nodes = list(param.topological_ordering())
    if len(nodes) == 1 and isinstance(nodes[0], _SLOT_READS):
        return nodes[0].slot
    if (
        len(nodes) == 2
        and isinstance(nodes[0], _SLOT_READS)
        and isinstance(nodes[1], JaxMixingWeightParameter)
    ):
        return nodes[0].slot
    return None


# weight-graph ops that keep the circuit output MULTILINEAR in every slot's
# rows: each output monomial contains exactly one entry per slot, so the
# flow identity holds for each slot independently
_FLOW_LINEAR_OPS = (JaxMixingWeightParameter, JaxMatMulParameter)


def _flow_slots(param: JaxParameter) -> list[str]:
    """Every store slot of a sum-style weight graph for which the flow
    identity ``flows = theta * dLL/dtheta`` holds.

    Beyond the bare-slot and slot->MixingWeight cases, this accepts any
    DAG composed solely of slots, MixingWeight (0/1 block-diagonal
    placement) and MatMul nodes with each slot read once — the compiled
    form of SumCollapse-fused sum chains (``optimization.py``). A fused
    ``W = W1 @ MW(W2)`` stays linear in each factor's rows, so each
    latent sum's expected flows are exactly ``Wi * dLL/dWi`` and the
    per-slot renormalized M-step reproduces EM on the *uncollapsed*
    latent chain.
    """
    nodes = list(param.topological_ordering())
    slots = [n for n in nodes if isinstance(n, _SLOT_READS)]
    ops = [n for n in nodes if not isinstance(n, _SLOT_READS)]
    if not slots or len({n.slot for n in slots}) != len(slots):
        return []
    if all(isinstance(n, _FLOW_LINEAR_OPS) for n in ops):
        return [n.slot for n in slots]
    return []


def _slot_read_counts(circuit: JaxCircuit) -> dict[str, int]:
    """How many weight-graph reads each store slot has across the circuit
    (tensor slots + pointers), including wrapped sub-module layers
    (evidence-derived circuits wrap leaves)."""
    from cirkit_tpu.backend.jax.circuit import _iter_param_nodes

    counts: dict[str, int] = {}
    for layer in circuit.layers:
        for n in _iter_param_nodes(layer):
            if isinstance(n, _SLOT_READS):
                counts[n.slot] = counts.get(n.slot, 0) + 1
    return counts


def _leaf_slot(
    param: JaxParameter,
    read_counts: dict[str, int],
    store: Store | None = None,
) -> str | None:
    """The slot behind a Gaussian/Binomial leaf parameter when the
    closed-form per-layer M-step can address it: a bare read whose layer
    folds align 1:1 with the slot folds (a tensor slot, or a pointer with
    a FULL identity fold map — with a ``store``, a prefix-identity subset
    read is also rejected) and which no other layer reads — the per-layer
    offset counts S0 pair ELEMENTWISE with the slot-fold gradients, so a
    permuted, partial, or shared read would misalign/double-count them
    (unlike the sum/categorical path, whose normalized-flow update is
    gather-exact)."""
    nodes = list(param.topological_ordering())
    if len(nodes) != 1:
        return None
    n = nodes[0]
    if isinstance(n, JaxPointerSlot):
        idx = n.fold_idx
        if idx is not None:
            if not np.array_equal(idx, np.arange(len(idx))):
                return None
            if store is not None and np.shape(store[n.slot])[0] != len(idx):
                return None
    elif not isinstance(n, JaxTensorSlot):
        return None
    if read_counts.get(n.slot, 0) > 1:
        return None
    return n.slot


def em_slots(circuit: JaxCircuit) -> dict[str, str]:
    """The EM-updatable slots of a compiled circuit: ``slot -> kind``
    (``"sum"`` or ``"categorical"``). Raises if a sum-style layer's weight
    is reparameterized (EM needs plain normalized weight tensors).
    Non-learnable slots (``ConstantParameter`` — e.g. the indicator leaves
    of a distilled tree) are frozen, matching ``fit()``'s
    ``learnable_slots`` contract."""
    learnable = circuit.learnable_slots
    slots: dict[str, str] = {}
    shared_fixed = 0
    for layer in circuit.layers:
        if isinstance(layer, (JaxSumLayer, JaxCPTLayer, JaxTuckerLayer, JaxTensorDotLayer)):
            layer_slots = [
                n.slot
                for p in layer.params.values()
                for n in p.topological_ordering()
                if isinstance(n, _SLOT_READS)
            ]
            if not any(s in learnable for s in layer_slots):
                continue  # entirely frozen (ConstantParameter): fixed by intent
            found = _flow_slots(layer.weight)
            if not found:
                weight_nodes = list(layer.weight.topological_ordering())
                if not any(isinstance(n, JaxTensorSlot) for n in weight_nodes):
                    # every read is a POINTER into an operand circuit
                    # (mixture/operator parameter sharing) and the graph is
                    # reparameterized (e.g. softmax weights trained by
                    # fit()): the flow identity does not hold, so the shared
                    # layer stays FIXED — blend-EM over trained components,
                    # not an error the user can fix without retraining
                    shared_fixed += 1
                    continue
                raise ValueError(
                    f"EM requires plain weight tensors, but a {type(layer).__name__} "
                    "weight is reparameterized; build the circuit with "
                    'Parameterization(activation="none", initialization="dirichlet")'
                )
            for slot in found:
                if slot in learnable:  # frozen (ConstantParameter) slots stay fixed
                    slots[slot] = "sum"
        elif isinstance(layer, JaxCategoricalLayer) and layer.probs is not None:
            slot = _flow_slot(layer.probs)
            if slot is not None and slot in learnable:
                slots[slot] = "categorical"
    if shared_fixed:
        warnings.warn(
            f"fit_em: {shared_fixed} sum-style layer(s) share REPARAMETERIZED "
            "weights with an operand circuit (pointer reads, e.g. softmax "
            "weights trained by fit()) — they stay fixed under EM; only "
            "plain (em_ready) parameters train",
            stacklevel=3,
        )
    if (
        not slots
        and not gaussian_em_layers(circuit)
        and not binomial_em_layers(circuit)
    ):
        raise ValueError("The circuit has no EM-updatable parameters")
    return slots


def gaussian_em_layers(
    circuit: JaxCircuit,
    store: Store | None = None,
) -> list[tuple[int, "JaxGaussianLayer", str, str]]:
    """Gaussian input layers whose mean AND stddev are plain *learnable*
    slots, as ``(layer_index, layer, mean_slot, stddev_slot)``; others
    (reparameterized or frozen ``ConstantParameter``) stay fixed. Passing
    a ``store`` also rejects partial (prefix-identity) pointer reads."""
    learnable = circuit.learnable_slots
    counts = _slot_read_counts(circuit)
    out = []
    for i, layer in enumerate(circuit.layers):
        if not isinstance(layer, JaxGaussianLayer) or layer.log_partition is not None:
            continue
        mean_slot = _leaf_slot(layer.mean, counts, store)
        std_slot = _leaf_slot(layer.stddev, counts, store)
        if (
            mean_slot in learnable
            and std_slot in learnable
        ):
            out.append((i, layer, mean_slot, std_slot))
    return out


def binomial_em_layers(
    circuit: JaxCircuit,
    store: Store | None = None,
) -> list[tuple[int, "JaxBinomialLayer", str, str]]:
    """Binomial input layers with a plain *learnable* ``probs`` or
    ``logits`` slot, as ``(layer_index, layer, slot, kind)`` with kind
    "probs"/"logits"; frozen (``ConstantParameter``) slots stay fixed.
    Passing a ``store`` also rejects partial (prefix-identity) pointer
    reads."""
    learnable = circuit.learnable_slots
    counts = _slot_read_counts(circuit)
    out = []
    for i, layer in enumerate(circuit.layers):
        if not isinstance(layer, JaxBinomialLayer):
            continue
        if layer.probs is not None:
            slot = _leaf_slot(layer.probs, counts, store)
            if slot in learnable:
                out.append((i, layer, slot, "probs"))
        else:
            slot = _leaf_slot(layer.logits, counts, store)
            if slot in learnable:
                out.append((i, layer, slot, "logits"))
    return out


def em_programs(
    circuit: JaxCircuit,
    store: Store,
    *,
    pseudocount: float = 1e-6,
    strict: bool = False,
    mesh: "jax.sharding.Mesh | None" = None,
    axis: str = "data",
    missing: bool = False,
):
    """The jitted E-step/M-step program pair behind :func:`fit_em`, for
    custom training loops and benchmarks.

    Returns ``(flow_step, em_update, state)`` where ``state`` is a dict with
    the partitioned parameters (``em_params``, ``gauss_params``) and a
    ``zero_acc()`` factory for fresh flow accumulators. Drive it as::

        acc, acc_ll = state["zero_acc"](), jnp.zeros(())
        acc, acc_ll = flow_step(em_params, gauss_params, acc, acc_ll, batch, weights)
        em_params, gauss_params = em_update(em_params, gauss_params, acc, step_size)

    ``weights`` is a per-sample (B,) weight vector (1.0 = count the sample;
    use 0.0 to mask padding rows). The flow accumulators are donated: treat
    ``acc``/``acc_ll`` as consumed by each ``flow_step`` call.

    With ``missing=True``, ``flow_step`` takes a trailing (B, D) boolean
    mask of missing entries and computes flows of the **marginal**
    likelihood — exact EM for missing-at-random data, run directly on the
    marginal model: a missing entry's input layer contributes its integral,
    so Gaussian/Binomial sufficient statistics impute the current moments
    with responsibility weight r (matching the classic closed forms), while
    a normalized categorical leaf contributes a constant — its update uses
    the observed entries only (the marginal likelihood is independent of a
    missing entry's leaf), and rows with no evidence at all keep their
    current distribution. Full-batch monotonicity holds for the marginal
    likelihood.
    """
    store = dict(circuit.restrict_store(store))
    slots = em_slots(circuit)
    gauss = gaussian_em_layers(circuit, store)
    binom = binomial_em_layers(circuit, store)
    leaf_types = (JaxCategoricalLayer, JaxGaussianLayer, JaxBinomialLayer)
    learnable = circuit.learnable_slots

    def _leaf_learnable(layer) -> bool:
        """False when every slot behind the leaf is frozen (non-learnable
        constants, e.g. a distilled tree's indicator leaves) — then the
        leaf staying fixed is by construction, not a silent no-op."""
        return any(
            n.slot in learnable
            for p in layer.params.values()
            for n in p.topological_ordering()
            if isinstance(n, _SLOT_READS)
        )

    has_leaves = any(
        isinstance(l, leaf_types) and _leaf_learnable(l) for l in circuit.layers
    )
    leaves_updatable = (
        bool(gauss) or bool(binom) or any(v == "categorical" for v in slots.values())
    )
    if has_leaves and not leaves_updatable:
        msg = (
            "fit_em: the circuit has input leaves but none are EM-updatable "
            "(their parameters are reparameterized, e.g. the default "
            "ScaledSigmoid Gaussian stddev) — only sum weights will train. "
            "Build the template with em_ready=True (or plain leaf parameter "
            "slots) to train the leaves; strict=True turns this into an error."
        )
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=3)
    gauss_slots = {s for _, _, ms, ss in gauss for s in (ms, ss)}
    gauss_slots |= {s for _, _, s, _ in binom}
    em_params = {k: jnp.asarray(store[k]) for k in slots}
    gauss_params = {k: jnp.asarray(store[k]) for k in gauss_slots}
    frozen = {
        k: jnp.asarray(v)
        for k, v in store.items()
        if k not in slots and k not in gauss_slots
    }
    if mesh is not None:
        from cirkit_tpu.parallel.training import replicate_store

        em_params = replicate_store(em_params, mesh)
        gauss_params = replicate_store(gauss_params, mesh)
        frozen = replicate_store(frozen, mesh)

    # zero additive offsets on each EM-Gaussian layer's log-output: the
    # gradient w.r.t. them is the layer's expected unit count S0 (the E-step
    # responsibilities), at no extra evaluation cost
    off_layers = [(i, layer) for i, layer, _, _ in gauss]
    off_layers += [(i, layer) for i, layer, _, _ in binom]
    layer_to_off = {id(layer): f"__off{i}" for i, layer in off_layers}
    off_zeros = {
        f"__off{i}": jnp.zeros(
            (layer.num_folds, 1, layer.num_output_units), jnp.result_type(float)
        )
        for i, layer in off_layers
    }

    def _make_module_fn(miss):
        """Per-layer override: optional missing-entry marginalization (the
        shared masked-integrate select; multivariate layers raise, like
        fit's loss) composed with the EM offset injection."""
        from cirkit_tpu.backend.jax.queries import masked_leaf_select

        def fn(layer, st, xin):
            out = layer(st, xin)
            if miss is not None:
                out = masked_leaf_select(layer, st, out, miss)
            name = layer_to_off.get(id(layer))
            if name is not None:
                out = out + st[name]
            return out

        return fn

    def _flow_step(em_p, g_p, acc, acc_ll, batch, weights, miss=None):
        """One E-step batch, accumulation fused into the jitted program (no
        eager op chain per batch)."""

        def total_ll(p_all):
            p, gp, off = p_all
            st = {**p, **gp, **off, **frozen}
            ll = circuit.evaluate(
                st,
                batch,
                module_fn=(
                    _make_module_fn(miss)
                    if (off_layers or miss is not None)
                    else None
                ),
            )
            per_sample = jnp.sum(ll.reshape(ll.shape[0], -1), axis=1)
            return jnp.sum(per_sample * weights)

        ll, (g_em, g_gauss, g_off) = jax.value_and_grad(total_ll)(
            (em_p, g_p, off_zeros)
        )
        acc_f, acc_g, acc_o = acc
        flows = jax.tree_util.tree_map(lambda p, g, a: a + p * g, em_p, g_em, acc_f)
        acc_g = jax.tree_util.tree_map(jnp.add, acc_g, g_gauss)
        acc_o = jax.tree_util.tree_map(jnp.add, acc_o, g_off)
        return (flows, acc_g, acc_o), acc_ll + ll

    if not missing:
        _fs = lambda em_p, g_p, acc, acc_ll, batch, weights: _flow_step(  # noqa: E731
            em_p, g_p, acc, acc_ll, batch, weights
        )
    else:
        _fs = _flow_step
    if mesh is None:
        # warm-compile cache: a second EM process deserializes the flow
        # step instead of compiling it (same pattern as the
        # fit train step; the fingerprint covers the plan + slot structure)
        from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

        flow_step = CachedJit(
            _fs,
            name="em_flow",
            key_parts=(circuit_fingerprint(circuit), bool(missing)),
            donate_argnums=(2, 3),
        )
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        repl = NamedSharding(mesh, P())
        shard = NamedSharding(mesh, P(axis))
        in_sh = (repl, repl, repl, repl, shard, shard)
        if missing:
            in_sh = in_sh + (shard,)
        flow_step = jax.jit(
            _fs,
            in_shardings=in_sh,
            out_shardings=(repl, repl),
            donate_argnums=(2, 3),
        )

    def em_update(em_p, g_p, acc, step_size):
        flows, acc_g, acc_o = acc

        def upd(p, f):
            # rows with ~zero total flow carry no evidence (dead units, or a
            # fully-missing variable under missing-data EM): keep the current
            # distribution instead of resetting to the pseudocount uniform
            tot = jnp.sum(f, axis=-1, keepdims=True)
            k = f.shape[-1]
            target = (f + pseudocount) / (tot + k * pseudocount)
            target = jnp.where(tot > 1e-6, target, p)
            return (1.0 - step_size) * p + step_size * target

        new_em = jax.tree_util.tree_map(upd, em_p, flows)
        new_g = dict(g_p)
        for i, layer, mean_slot, std_slot in gauss:
            mu, sd = g_p[mean_slot], g_p[std_slot]
            s0 = acc_o[f"__off{i}"][:, 0, :]  # (F, K) expected counts
            g_mu, g_sd = acc_g[mean_slot], acc_g[std_slot]
            ok = s0 > 1e-6
            s0s = jnp.where(ok, s0, 1.0)
            # weighted sufficient stats recovered from the gradients:
            # g_mu = S1'/sd^2 with S1' = sum r (x - mu);
            # g_sd = sum r (x-mu)^2 / sd^3 - S0 / sd
            mu_t = mu + sd * sd * g_mu / s0s
            sum_sq = sd**3 * g_sd + sd * sd * s0
            var_t = (sum_sq - s0 * jnp.square(mu_t - mu)) / s0s
            sd_t = jnp.sqrt(jnp.maximum(var_t, 1e-8))
            mu_n = jnp.where(ok, (1.0 - step_size) * mu + step_size * mu_t, mu)
            sd_n = jnp.where(ok, (1.0 - step_size) * sd + step_size * sd_t, sd)
            new_g[mean_slot] = mu_n
            new_g[std_slot] = sd_n
        for i, layer, slot, kind in binom:
            n = layer.total_count
            s0 = acc_o[f"__off{i}"][:, 0, :]
            g = acc_g[slot]
            ok = s0 > 1e-6
            s0s = jnp.where(ok, s0, 1.0)
            theta = g_p[slot]
            if kind == "logits":
                # d log pmf/dtheta = k - n*sigmoid(theta):
                # sum r k = g + n p S0 -> p' = p + g / (n S0)
                p0 = jax.nn.sigmoid(theta)
                p_t = p0 + g / (n * s0s)
            else:
                # d log pmf/dp = k/p - (n-k)/(1-p):
                # sum r k = p(1-p) g + n p S0 -> p' = p + p(1-p) g / (n S0)
                p0 = theta
                p_t = p0 + p0 * (1.0 - p0) * g / (n * s0s)
            p_t = jnp.clip(p_t, 1e-7, 1.0 - 1e-7)
            p_n = jnp.where(ok, (1.0 - step_size) * p0 + step_size * p_t, p0)
            new_g[slot] = (
                jnp.log(p_n) - jnp.log1p(-p_n) if kind == "logits" else p_n
            )
        return new_em, new_g

    if mesh is None:
        from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

        em_update = CachedJit(
            em_update,
            name="em_update",
            key_parts=(circuit_fingerprint(circuit), bool(missing), pseudocount),
        )
    else:
        em_update = jax.jit(em_update)

    def zero_acc():
        return (
            jax.tree_util.tree_map(jnp.zeros_like, em_params),
            jax.tree_util.tree_map(jnp.zeros_like, gauss_params),
            jax.tree_util.tree_map(jnp.zeros_like, off_zeros),
        )

    state = {
        "em_params": em_params,
        "gauss_params": gauss_params,
        "frozen": frozen,
        "zero_acc": zero_acc,
        "store": store,
    }
    return flow_step, em_update, state


def fit_em(
    circuit: JaxCircuit,
    data: np.ndarray | jnp.ndarray,
    *,
    store: Store | None = None,
    num_epochs: int = 1,
    batch_size: int = 1024,
    step_size: float | str | Callable[[int], float] = 1.0,
    update_every: str = "epoch",
    pseudocount: float = 1e-6,
    shuffle: bool = False,
    strict: bool = False,
    key: jax.Array | None = None,
    mesh: "jax.sharding.Mesh | None" = None,
    axis: str = "data",
    missing: str | float | int | None = None,
    sample_weight: "np.ndarray | jnp.ndarray | None" = None,
    checkpoint_every: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
) -> tuple[Store, list[float]]:
    """Train a circuit by (mini-batch) EM.

    Per epoch: accumulate expected flows over all batches (one forward +
    backward each, no optimizer state), then update every EM slot to the
    renormalized flows — interpolated with the previous weights when
    ``step_size < 1`` (damped EM). ``step_size=1.0`` is exact full-dataset
    EM, which increases the train log-likelihood monotonically.

    ``update_every="batch"`` switches to **online (mini-batch) EM**: the
    M-step runs after every batch on that batch's flows, damped by
    ``step_size`` — much faster progress per pass on large datasets, at the
    cost of the full-batch monotonicity guarantee.

    ``step_size`` may also be a *schedule*: the string ``"robbins-monro"``
    (the classic stochastic-approximation decay ``(t + 2) ** -0.75`` of
    Sato 1999 / Cappé & Moulines 2009, satisfying the Robbins-Monro
    conditions) or any callable ``t -> float`` of the 0-based M-step
    counter. Schedules pair with ``update_every="batch"``; the step size is
    a runtime scalar, so schedules do not retrace the update program.

    Input leaves update only when their parameter slots are *plain* (see
    module docstring); build templates with ``em_ready=True`` to get
    EM-eligible leaf parameterizations. When the circuit has input leaves
    but none are EM-updatable, a warning is emitted (sum weights still
    train); pass ``strict=True`` to raise instead.

    ``missing`` enables EM over incomplete data: pass ``"nan"`` (float
    data; a NaN float value is accepted too) or a sentinel value (e.g.
    ``-1`` for categorical data). Missing entries are marginalized per
    sample and the E-step runs on the marginal likelihood — exact
    missing-at-random EM, monotone, no imputation (semantics per leaf
    family in :func:`em_programs`).

    ``sample_weight`` (length ``len(data)``, nonnegative) runs **weighted
    EM**: the E-step responsibilities scale by each sample's weight (the
    flows are gradients of ``sum_i w_i log p(x_i)``) and the closed-form
    M-step renormalizes, so an integer-weighted run is exactly EM on the
    correspondingly replicated dataset. Losses become weight-normalized
    mean NLLs.

    With a ``mesh``, the batch shards over the ``axis`` and parameters/flow
    accumulators replicate: the flows are gradients, so XLA inserts the
    same all-reduce as data-parallel SGD and the result is bitwise the
    single-device recursion.

    ``checkpoint_every=N`` writes an atomic checkpoint (EM parameters +
    epoch/M-step counters + losses) to ``checkpoint_path`` every N
    *epochs*; ``resume=True`` restores it if present and continues from
    the next epoch — deterministic given the same data/batch_size/key, so
    a resumed run reproduces the uninterrupted one (schedules stay aligned
    through the restored M-step counter).

    Returns the updated store and the mean train NLL per epoch. With
    ``update_every="epoch"`` each entry is measured under the weights
    before that epoch's update; in online mode parameters change mid-epoch,
    so the entry mixes batch losses under the evolving within-epoch
    weights (still a faithful progress signal, not a fixed-parameter NLL).
    """
    if store is None:
        store = getattr(circuit, "default_store", None)
        if store is None:
            raise ValueError("No parameter store bound; pass store=...")
    if key is None:
        key = jax.random.PRNGKey(0)
    if mesh is not None and batch_size % mesh.devices.size != 0:
        raise ValueError("The batch size must divide evenly across the mesh devices")
    if update_every not in ("epoch", "batch"):
        raise ValueError(f"update_every must be 'epoch' or 'batch', got {update_every!r}")
    if (checkpoint_every is not None or resume) and checkpoint_path is None:
        raise ValueError("checkpoint_every/resume require checkpoint_path")
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if callable(step_size):
        schedule = step_size
    elif isinstance(step_size, str):
        if step_size != "robbins-monro":
            raise ValueError(f"Unknown step-size schedule {step_size!r}")
        schedule = lambda t: (t + 2.0) ** -0.75  # noqa: E731
    else:
        schedule = None

    data = np.asarray(data)
    if not jax.config.jax_enable_x64:
        if data.dtype == np.int64:
            data = data.astype(np.int32)
        elif data.dtype == np.float64:
            data = data.astype(np.float32)
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, np.float32).ravel()
        if sample_weight.shape[0] != len(data):
            raise ValueError(
                f"sample_weight has {sample_weight.shape[0]} entries for "
                f"{len(data)} samples"
            )
        if np.any(sample_weight < 0) or not np.all(np.isfinite(sample_weight)):
            raise ValueError("sample_weight entries must be finite and >= 0")
    if checkpoint_path is not None:
        from cirkit_tpu.utils.checkpoint import data_fingerprint

        # ck_schedule: `schedule` is the step-size schedule above
        ck_schedule = np.asarray([len(data), batch_size, int(shuffle)], np.int64)
        ck_data_fp = data_fingerprint(data)
        if sample_weight is not None:
            # resume must replay the same weighted objective
            ck_data_fp = ck_data_fp ^ data_fingerprint(sample_weight)
    if isinstance(missing, float) and np.isnan(missing):
        missing = "nan"  # accept the float spelling of NaN
    if missing == "nan":
        if not np.issubdtype(data.dtype, np.floating):
            raise ValueError('missing="nan" requires floating-point data')
        miss_all = np.isnan(data)
        data = np.nan_to_num(data, nan=0.0)
    elif missing is not None:
        miss_all = data == missing
        data = np.where(miss_all, np.zeros((), data.dtype), data)
    else:
        miss_all = None

    flow_step, em_update, state = em_programs(
        circuit, store, pseudocount=pseudocount, strict=strict, mesh=mesh, axis=axis,
        missing=miss_all is not None,
    )
    em_params, gauss_params = state["em_params"], state["gauss_params"]
    store, _zero_acc = state["store"], state["zero_acc"]

    num_batches = -(-len(data) // batch_size)
    _total_weight = (
        float(len(data)) if sample_weight is None
        else max(float(np.sum(sample_weight, dtype=np.float64)), 1e-30)
    )
    losses: list[float] = []
    m_steps = 0
    start_epoch = 0
    if resume:
        from cirkit_tpu.utils.checkpoint import load_training_state, place_replicated

        restored = load_training_state(
            checkpoint_path,
            like={
                "em_params": em_params,
                "gauss_params": gauss_params,
                "epoch": np.int64(0),
                "m_steps": np.int64(0),
                "losses": np.zeros(0),
                "schedule": ck_schedule,
                "data_fp": ck_data_fp,
            },
        )
        if restored is not None:
            if not np.array_equal(restored["schedule"], ck_schedule) or int(
                restored["data_fp"]
            ) != int(ck_data_fp):
                raise ValueError(
                    "Checkpoint was written for a different run: exact resume "
                    "replays the original batch schedule, so data, batch_size "
                    f"and shuffle must match (saved len/batch/shuffle="
                    f"{restored['schedule'].tolist()}, this run="
                    f"{ck_schedule.tolist()})"
                )
            start_epoch = int(np.asarray(restored["epoch"]))
            m_steps = int(np.asarray(restored["m_steps"]))
            losses = [float(v) for v in np.asarray(restored["losses"]).ravel()]
            if start_epoch > num_epochs:
                raise ValueError(
                    f"Checkpoint at epoch {start_epoch} is beyond this run's "
                    f"{num_epochs} epochs — resume with the same (or more) epochs"
                )
            em_params = place_replicated(restored["em_params"], mesh)
            gauss_params = place_replicated(restored["gauss_params"], mesh)

    def _step_size():
        s = step_size if schedule is None else schedule(m_steps)
        return jnp.asarray(s, dtype=jnp.result_type(float))

    def _save_ck(done_epochs: int) -> None:
        from cirkit_tpu.utils.checkpoint import save_training_state

        save_training_state(
            checkpoint_path,
            {
                "em_params": em_params,
                "gauss_params": gauss_params,
                "epoch": np.int64(done_epochs),
                "m_steps": np.int64(m_steps),
                "losses": np.asarray(losses, np.float64),
                "schedule": ck_schedule,
                "data_fp": ck_data_fp,
            },
        )

    from cirkit_tpu.parallel.training import Preempted, _PreemptionGuard

    guard = _PreemptionGuard(checkpoint_every is not None)
    guard.__enter__()
    try:
        for epoch in range(num_epochs):
            if epoch < start_epoch:
                if shuffle:
                    # replay the key evolution so resumed epochs see the same
                    # permutations the uninterrupted run would have
                    key, _ = jax.random.split(key)
                continue
            if shuffle:
                key, sub = jax.random.split(key)
                perm = np.asarray(jax.random.permutation(sub, len(data)))
            else:
                perm = np.arange(len(data))
            acc = _zero_acc()
            acc_ll = jnp.zeros(())
            for b in range(num_batches):
                idx = perm[b * batch_size : (b + 1) * batch_size]
                if sample_weight is None:
                    weights = np.ones(batch_size, np.float32)
                    weights[len(idx) :] = 0.0
                else:
                    weights = np.zeros(batch_size, np.float32)
                    weights[: len(idx)] = sample_weight[idx]
                if len(idx) < batch_size:
                    idx = np.concatenate([idx, np.zeros(batch_size - len(idx), idx.dtype)])
                batch, w = jnp.asarray(data[idx]), jnp.asarray(weights)
                miss = jnp.asarray(miss_all[idx]) if miss_all is not None else None
                if mesh is not None:
                    from cirkit_tpu.parallel.training import shard_batch

                    batch, w = shard_batch(batch, mesh, axis), shard_batch(w, mesh, axis)
                    if miss is not None:
                        miss = shard_batch(miss, mesh, axis)
                if update_every == "batch":
                    acc = _zero_acc()
                fs_args = (em_params, gauss_params, acc, acc_ll, batch, w)
                if miss is not None:
                    fs_args = fs_args + (miss,)
                acc, acc_ll = flow_step(*fs_args)
                if update_every == "batch":
                    em_params, gauss_params = em_update(
                        em_params, gauss_params, acc, _step_size()
                    )
                    m_steps += 1
            if update_every == "epoch":
                em_params, gauss_params = em_update(em_params, gauss_params, acc, _step_size())
                m_steps += 1
            losses.append(-float(acc_ll) / _total_weight)
            if guard.flag is not None:
                _save_ck(epoch + 1)
                raise Preempted(
                    f"fit_em() caught signal {guard.flag} after epoch {epoch + 1}; "
                    f"checkpoint written to {checkpoint_path} — rerun with "
                    "resume=True to continue"
                )
            if checkpoint_every is not None and (epoch + 1) % checkpoint_every == 0:
                _save_ck(epoch + 1)
    finally:
        guard.__exit__()

    new_store = dict(store)
    new_store.update(em_params)
    new_store.update(gauss_params)
    circuit.default_store = {**getattr(circuit, "default_store", {}), **new_store}
    return new_store, losses
