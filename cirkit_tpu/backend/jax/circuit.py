"""The compiled circuit: a static evaluation plan executed under jit.

Replaces the reference's nn.Module graph + Python interpreter loop
(``cirkit/backend/torch/graph/modules.py:239-335`` and ``circuits.py``) with
a **compile-to-plan** design: the folded circuit is lowered to a static list
of plan entries — (layer, input gather indices) — executed by one traced
function. All gather indices are numpy constants baked into the XLA graph,
so inter-layer routing compiles to fused gathers/reshapes; there is no
per-step Python overhead at run time (the loop unrolls at trace time).
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.layers import (
    JaxConstantInputLayer,
    JaxInputLayer,
    JaxLayer,
)
from cirkit_tpu.backend.jax.parameters import JaxTensorSlot, Store
from cirkit_tpu.backend.jax.semiring import Semiring

tmap = jax.tree_util.tree_map
"""Semiring values are pytrees (a bare array for most semirings, a
(logmag, sign) pair for the signed one); every plan-level value operation
maps over the leaves so the executor is representation-agnostic."""
from cirkit_tpu.symbolic.circuit import StructuralProperties
from cirkit_tpu.utils.scope import Scope

# For every layer: per fold, the ordered (producer layer index, fold within
# producer) pairs feeding each operand slot. Input layers have no entries.
FoldInputs = list[list[tuple[int, int]]]

# A module evaluation override: (layer, store, gathered_input) -> output.
ModuleFn = Callable[[JaxLayer, Store, Any], jnp.ndarray]


@dataclass
class PlanEntry:
    """One step of the evaluation plan."""

    layer: JaxLayer
    # Inner layers: producer plan indices + either a (F, H) gather into the
    # fold-concatenation of their outputs, or None for the identity unsqueeze
    # special case (ref: ``graph/folding.py:232-241``).
    in_ids: list[int] = field(default_factory=list)
    fold_idx: np.ndarray | None = None


@dataclass
class OutputSpec:
    """How circuit outputs are assembled from plan outputs."""

    out_ids: list[int]
    fold_idx: np.ndarray | None  # (O,) into the fold-concatenation


def _build_gather(
    producers: FoldInputs, plan_index: Mapping[int, int], layer_folds: Mapping[int, int]
) -> tuple[list[int], np.ndarray | None]:
    """Compute (in_ids, fold_idx) for a layer's fold-input spec."""
    in_ids: list[int] = []
    offsets: dict[int, int] = {}
    total = 0
    for per_fold in producers:
        for mod, _ in per_fold:
            if mod not in offsets:
                offsets[mod] = total
                total += layer_folds[mod]
                in_ids.append(mod)
    fold_idx = np.array(
        [[offsets[mod] + k for mod, k in per_fold] for per_fold in producers],
        dtype=np.int32,
    )
    f, h = fold_idx.shape
    if len(in_ids) == 1 and h == 1 and np.array_equal(fold_idx[:, 0], np.arange(f)):
        if layer_folds[in_ids[0]] == f:
            return [plan_index[m] for m in in_ids], None
    return [plan_index[m] for m in in_ids], fold_idx


def _pad_rows(pad: int | None, x, *masks):
    """Round the batch up to a multiple of ``pad`` by repeating row 0
    (2-D array masks with a matching batch alike); returns
    ``(x, *masks, original_b_or_None)``. One compiled program then serves
    every serving batch size — each new shape is a fresh compile — and
    callers slice outputs back to ``b``. Host (numpy/list)
    inputs pad host-side so new ragged sizes dispatch NO extra device
    programs; single-``Scope`` specs pass through (they broadcast from the
    padded ``x``), but per-row Scope lists cannot pad and raise."""
    if pad is None:
        return (x, *masks, None)
    if pad <= 0:
        raise ValueError("pad_batch_to must be a positive integer")
    on_device = isinstance(x, jnp.ndarray)
    x = jnp.asarray(x) if on_device else np.asarray(x)
    b = x.shape[0]
    bp = -(-b // pad) * pad
    if bp == b:
        return (x, *masks, None)

    def ext(a):
        lib = jnp if isinstance(a, jnp.ndarray) else np
        a = lib.asarray(a)
        return lib.concatenate(
            [a, lib.broadcast_to(a[:1], (bp - b, *a.shape[1:]))], axis=0
        )

    padded = []
    for m in masks:
        if (
            isinstance(m, (jnp.ndarray, np.ndarray))
            and np.ndim(m) >= 2
            and np.shape(m)[0] == b
        ):
            padded.append(ext(m))
        elif isinstance(m, (list, tuple)) and len(m) == b and b > 1:
            raise ValueError(
                "pad_batch_to cannot pad a per-row list of Scopes; pass the "
                "evidence as a boolean array (or a single broadcast Scope)"
            )
        else:
            padded.append(m)
    return (ext(x), *padded, b)


def _slice_rows(out, b: int | None):
    """Undo :func:`_pad_rows` on every array leaf of ``out``."""
    if b is None:
        return out
    return jax.tree_util.tree_map(lambda a: a[:b], out)



class JaxCircuit:
    """A compiled circuit: layers + static plan, evaluated functionally.

    The circuit itself holds no arrays: parameters live in a *store* pytree
    (dict slot name -> (F, ...) array) created by :meth:`initialize` and
    threaded through every call, so optax/orbax/shard_map apply directly.
    """

    def __init__(
        self,
        scope: Scope,
        num_variables: int,
        layers: Sequence[JaxLayer],
        fold_inputs: Mapping[int, FoldInputs],
        fold_outputs: FoldInputs,
        *,
        properties: StructuralProperties,
        semiring: Semiring,
    ):
        self.scope = scope
        self.num_variables = num_variables
        self.layers = list(layers)
        self.properties = properties
        self.semiring = semiring
        self._fold_inputs = dict(fold_inputs)
        self._fold_outputs = fold_outputs

        # -- build the plan ----------------------------------------------------
        layer_folds = {i: l.num_folds for i, l in enumerate(self.layers)}
        plan_index = {i: i for i in range(len(self.layers))}
        self._entries: list[PlanEntry] = []
        for i, layer in enumerate(self.layers):
            if isinstance(layer, JaxInputLayer):
                self._entries.append(PlanEntry(layer))
                continue
            in_ids, fold_idx = _build_gather(fold_inputs[i], plan_index, layer_folds)
            self._entries.append(PlanEntry(layer, in_ids, fold_idx))
        # flatten the (module, fold) output pairs into a single gather
        out_ids, out_fold = _build_gather(
            [[p] for p in fold_outputs], plan_index, layer_folds
        )
        self._outputs = OutputSpec(out_ids, None if out_fold is None else out_fold[:, 0])
        self.num_outputs = len(fold_outputs)

        # -- collect the parameter store specification -------------------------
        self._slots: dict[str, JaxTensorSlot] = {}
        used: set[str] = set()
        ptr_learnable: set[str] = set()
        for layer in self.layers:
            for node in _iter_param_nodes(layer):
                if isinstance(node, JaxTensorSlot):
                    self._slots.setdefault(node.slot, node)
                    used.add(node.slot)
                elif hasattr(node, "slot"):
                    used.add(node.slot)
                    if getattr(node, "learnable", False):
                        ptr_learnable.add(node.slot)
        self._used_slots: tuple[str, ...] = tuple(sorted(used))
        # learnable slots this circuit only POINTS at (parameter sharing with
        # operand circuits): fit()/fit_em() on a derived circuit trains them
        self._shared_learnable: frozenset[str] = frozenset(
            ptr_learnable - set(self._slots)
        )

        self._jit_cache: dict[Any, Callable] = {}
        self._init_jit: Callable | None = None

    # -- parameter store -------------------------------------------------------
    @property
    def slots(self) -> Mapping[str, JaxTensorSlot]:
        """The parameter-store slot specification of this circuit."""
        return self._slots

    @property
    def learnable_slots(self) -> frozenset[str]:
        return (
            frozenset(s for s, n in self._slots.items() if n.learnable)
            | self._shared_learnable
        )

    @property
    def shared_learnable_slots(self) -> frozenset[str]:
        """Learnable slots this circuit only POINTS at — parameters shared
        with operand circuits (mixture components, operator sources).
        ``fit(..., freeze="shared")`` keeps exactly these fixed."""
        return self._shared_learnable

    def initialize(self, key: jax.Array | None = None) -> dict[str, jnp.ndarray]:
        """Build a freshly-initialized parameter store (a flat pytree).

        Constant slots materialize in numpy; all random draws run in a single
        jitted program (one device dispatch per circuit, not per parameter).
        """
        from cirkit_tpu.backend.jax.parameters import _host_init

        const_slots = []
        host_slots = []
        random_slots = []
        use_host = _host_init()
        for s in sorted(self._slots):
            node = self._slots[s]
            if all(getattr(init, "constant", None) is not None for init in node.inits):
                const_slots.append(s)
            elif node.host_initializable and use_host:
                host_slots.append(s)
            else:
                random_slots.append(s)
        store = {s: self._slots[s].initialize(None) for s in const_slots}
        if host_slots or random_slots:
            if key is None:
                raise ValueError(
                    "A PRNG key is required to initialize randomly-initialized parameters"
                )
        if host_slots:
            # numpy draws, no XLA programs: each slot derives its own rng
            ks = jax.random.split(key, len(host_slots) + 1)
            key = ks[0]
            store.update(
                {s: self._slots[s].initialize(ks[i + 1]) for i, s in enumerate(host_slots)}
            )
        if random_slots:
            # Jit the random draws into one program only on accelerators and
            # when there are few slots (folded circuits): one compile + one
            # dispatch instead of one per slot (each eager op is its own XLA
            # program). Enable jax's persistent compilation cache to
            # amortize across runs.
            if jax.default_backend() != "cpu" and len(random_slots) <= 64:
                if self._init_jit is None:
                    slots = tuple(random_slots)

                    def _init_random(k):
                        # draw under the rbg PRNG: XLA's RngBitGenerator
                        # makes each GB-sized flagship draw one op, where
                        # threefry hashes every element
                        k = jax.random.wrap_key_data(
                            jnp.tile(jax.random.key_data(k), 2), impl="rbg"
                        )
                        ks = jax.random.split(k, len(slots))
                        return {
                            s: self._slots[s].initialize(ks[i]) for i, s in enumerate(slots)
                        }

                    # warm-compile cache: a second process deserializes the
                    # init executable instead of compiling it
                    from cirkit_tpu.backend.jax.warmcache import (
                        CachedJit,
                        circuit_fingerprint,
                    )

                    self._init_jit = CachedJit(
                        _init_random,
                        name="init",
                        key_parts=(circuit_fingerprint(self), slots),
                    )
                store.update(self._init_jit(key))
            else:
                ks = jax.random.split(key, len(random_slots))
                store.update(
                    {s: self._slots[s].initialize(ks[i]) for i, s in enumerate(random_slots)}
                )
        return store

    def num_parameters(self, store: Store | None = None, *, learnable_only: bool = False) -> int:
        total = 0
        for s, node in self._slots.items():
            if learnable_only and not node.learnable:
                continue
            total += node.num_folds * int(np.prod(node.shape))
        return total

    # -- evaluation --------------------------------------------------------------
    def evaluate(
        self,
        store: Store,
        x: jnp.ndarray | None = None,
        *,
        batch_size: int | None = None,
        module_fn: ModuleFn | None = None,
    ) -> jnp.ndarray:
        """Run the plan: (B, D) inputs -> (B, O, K) outputs.

        ``module_fn`` overrides per-layer evaluation — the hook used by
        queries (ref: ``graph/modules.py:303-335`` module_fn path).
        """
        out = self.evaluate_raw(store, x, batch_size=batch_size, module_fn=module_fn)
        return tmap(lambda o: jnp.transpose(o, (1, 0, 2)), out)  # (B, O, K)

    def evaluate_raw(
        self,
        store: Store,
        x: jnp.ndarray | None = None,
        *,
        batch_size: int | None = None,
        module_fn: ModuleFn | None = None,
    ) -> jnp.ndarray:
        """Run the plan returning the raw output stack (O, ...). When ``x``
        is None and ``module_fn`` is given, input layers receive None (the
        hook used by sampling, which needs no data batch)."""
        if x is not None:
            b = x.shape[0]
        elif batch_size is not None:
            b = batch_size
        elif module_fn is None:
            raise ValueError("Either an input batch or a batch size is required")
        else:
            b = None

        fn: ModuleFn = (lambda layer, st, xin: layer(st, xin)) if module_fn is None else module_fn

        outs: list[jnp.ndarray] = []
        for entry in self._entries:
            layer = entry.layer
            if isinstance(layer, JaxConstantInputLayer):
                y = fn(layer, store, b)
            elif isinstance(layer, JaxInputLayer):
                if x is None:
                    y = fn(layer, store, None)
                else:
                    # (B, D_total) -> (F, B, D) via the static scope gather;
                    # the common univariate-identity case (folded inputs over
                    # every variable in order) is a plain transpose
                    si = layer.scope_idx
                    if si.shape[1] == 1 and si.shape[0] == x.shape[1] and np.array_equal(
                        si[:, 0], np.arange(si.shape[0])
                    ):
                        xin = jnp.transpose(x, (1, 0))[:, :, None]
                    else:
                        xin = jnp.transpose(x[:, si], (1, 0, 2))
                    y = fn(layer, store, xin)
            else:
                cat = (
                    outs[entry.in_ids[0]]
                    if len(entry.in_ids) == 1
                    else tmap(
                        lambda *a: jnp.concatenate(a, axis=0),
                        *(outs[i] for i in entry.in_ids),
                    )
                )
                if entry.fold_idx is None:
                    xin = tmap(lambda c: c[:, None], cat)  # identity gather -> unsqueeze
                else:
                    xin = tmap(lambda c: c[entry.fold_idx], cat)  # (F, H, B, K)
                y = fn(layer, store, xin)
            outs.append(y)

        cat = (
            outs[self._outputs.out_ids[0]]
            if len(self._outputs.out_ids) == 1
            else tmap(
                lambda *a: jnp.concatenate(a, axis=0),
                *(outs[i] for i in self._outputs.out_ids),
            )
        )
        if self._outputs.fold_idx is None:
            return cat
        return tmap(lambda c: c[self._outputs.fold_idx], cat)

    def __call__(self, *args, **kwargs) -> jnp.ndarray:
        """Jit-compiled forward: ``cc(store, x)``, or ``cc(x)`` using the
        pipeline context's shared store (set at compile time)."""
        if args and isinstance(args[0], Mapping):
            store, *rest = args
        else:
            store = getattr(self, "default_store", None)
            if store is None:
                raise ValueError(
                    "No parameter store bound: call as cc(store, x) or compile "
                    "through a PipelineContext"
                )
            rest = list(args)
        x = rest[0] if rest else None
        return self.jit_evaluate(store, x, **kwargs)

    @property
    def used_slots(self) -> tuple[str, ...]:
        """Every store slot this circuit reads (own tensors + shared pointers)."""
        return self._used_slots

    def restrict_store(self, store: Store) -> dict[str, jnp.ndarray]:
        """Project a (possibly larger shared) store onto the used slots."""
        return {s: store[s] for s in self._used_slots}

    def jit_evaluate(
        self,
        store: Store,
        x: jnp.ndarray | None = None,
        *,
        batch_size: int | None = None,
        pad_batch_to: int | None = None,
    ) -> jnp.ndarray:
        """Jit-cached evaluation. ``pad_batch_to`` rounds the batch up to a
        multiple (padding with the first row, slicing the result back), so
        serving with varying batch sizes reuses one compiled program instead
        of recompiling per shape."""
        store = self.restrict_store(store)
        b = None
        if pad_batch_to is not None and x is not None:
            x, b = _pad_rows(pad_batch_to, x)
        key = "fwd" if batch_size is None else ("const", batch_size)
        if key not in self._jit_cache:
            # warm-compile cache (backend/jax/warmcache.py): fresh processes
            # load the serialized executable instead of re-compiling
            from cirkit_tpu.backend.jax.warmcache import CachedJit, circuit_fingerprint

            fp = circuit_fingerprint(self)
            if batch_size is None:
                self._jit_cache[key] = CachedJit(
                    lambda st, xx: self.evaluate(st, xx),
                    name="evaluate", key_parts=(fp,),
                )
            else:
                self._jit_cache[key] = CachedJit(
                    lambda st: self.evaluate(st, None, batch_size=batch_size),
                    name="evaluate_const", key_parts=(fp, batch_size),
                )
        fn = self._jit_cache[key]
        out = fn(store, x) if batch_size is None else fn(store)
        return out if b is None else out[:b]

    # -- introspection -----------------------------------------------------------
    def __repr__(self) -> str:
        lines = [f"{type(self).__name__}(scope={self.scope}, semiring={self.semiring.__name__})"]
        for i, e in enumerate(self._entries):
            src = "" if not e.in_ids else f" <- {e.in_ids}"
            lines.append(f"  [{i}] {e.layer!r}{src}")
        return "\n".join(lines)


def _iter_param_nodes(layer: JaxLayer):
    for p in layer.params.values():
        yield from p.nodes
    for sub in layer.sub_modules.values():
        yield from _iter_param_nodes(sub)
