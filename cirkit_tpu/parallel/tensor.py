"""Tensor-parallel circuit evaluation: model parallelism over the unit axis.

A new capability relative to the reference (single-device, SURVEY.md §2.7):
every layer's *output-unit* axis is sharded over a
``model`` mesh axis — sum/CPT/Tucker weights split by output unit, input
layers by unit — while the contractions' *input*-unit axes stay full via an
``all_gather`` of the (small) activations. Circuit activations are
(F, B, K) with K = 64-ish, so the gathered traffic is tiny compared to the
weight reads the sharding saves; this is the standard "shard the big tensor,
gather the small one" recipe.

Written with ``shard_map``: inside the mapped function every array is the
per-device shard and the collectives are explicit, so the contractions
run unchanged on local shapes. Gradients: the all_gathers transpose to
reduce-scatters automatically; replicated-parameter gradients are
``psum``-ed over the model axis and everything is ``pmean``-ed over the
data axis. The optimizer update runs outside the shard_map under ``jit``,
letting XLA propagate the parameter shardings through the elementwise
update.

Sharding is per-slot and conservative: a slot is sharded only when its
unit axis divides the model-axis size and its consuming layer/parameter
graph provably preserves the unit axis (entrywise reparameterizations and
last-axis softmax); everything else — mixing weights, Kronecker-structured
graphs, tensor-dot weights — stays replicated.
"""

from __future__ import annotations

from collections.abc import Callable
from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cirkit_tpu.backend.jax.circuit import JaxCircuit
from cirkit_tpu.backend.jax.layers import (
    JaxBinomialLayer,
    JaxCategoricalLayer,
    JaxConstantInputLayer,
    JaxEmbeddingLayer,
    JaxGaussianLayer,
    JaxHadamardLayer,
    JaxInputLayer,
    JaxKroneckerLayer,
    JaxSumLayer,
)
from cirkit_tpu.backend.jax.optimized import JaxCPTLayer, JaxTuckerLayer
from cirkit_tpu.backend.jax.parameters import (
    JaxParameter,
    JaxSoftmaxParameter,
    JaxTensorSlot,
    _EntrywiseOp,
)

Store = dict[str, jax.Array]


def _unit_shardable_slot(param: JaxParameter, num_shards: int) -> str | None:
    """The slot name if ``param`` is a unit-axis-preserving graph over a
    single tensor slot whose axis-1 divides ``num_shards``, else None."""
    slot = None
    for node in param.topological_ordering():
        if isinstance(node, JaxTensorSlot):
            if slot is not None:
                return None
            slot = node
        elif isinstance(node, _EntrywiseOp):
            continue
        elif isinstance(node, JaxSoftmaxParameter):
            # softmax over the trailing (input) axis keeps units independent
            if node.axis != len(node.shape) - 1:
                return None
        else:
            return None
    if slot is None or len(slot.shape) < 1:
        return None
    if slot.shape[0] % num_shards != 0 or slot.shape[0] // num_shards < 1:
        return None
    return slot.slot


def tp_slot_specs(circuit: JaxCircuit, num_shards: int) -> dict[str, int]:
    """Map slot name -> array axis to shard (always 1: the per-fold unit
    axis) for every slot this circuit can shard over ``num_shards`` model
    devices. Unlisted slots stay replicated."""
    specs: dict[str, int] = {}
    for layer in circuit.layers:
        params: list[JaxParameter] = []
        if isinstance(layer, (JaxSumLayer, JaxCPTLayer)) or (
            isinstance(layer, JaxTuckerLayer) and layer.arity == 2
        ):
            if layer.num_output_units % num_shards == 0:
                params.append(layer.weight)
        elif isinstance(layer, JaxCategoricalLayer):
            params.append(layer.probs if layer.logits is None else layer.logits)
        elif isinstance(layer, JaxBinomialLayer):
            params.append(layer.probs if layer.logits is None else layer.logits)
        elif isinstance(layer, JaxGaussianLayer):
            params.extend([layer.mean, layer.stddev])
            if layer.log_partition is not None:
                params.append(layer.log_partition)
        elif isinstance(layer, JaxEmbeddingLayer):
            params.append(layer.weight)
        if isinstance(layer, JaxInputLayer) and layer.num_output_units % num_shards:
            continue
        if isinstance(layer, (JaxGaussianLayer,)) and not all(
            _unit_shardable_slot(p, num_shards) for p in params
        ):
            continue  # mean/stddev must shard together
        for p in params:
            slot = _unit_shardable_slot(p, num_shards)
            if slot is not None:
                specs[slot] = 1
    return specs


def tp_routing_descriptor(
    circuit: JaxCircuit, mesh: Mesh, *, model_axis: str = "model"
):
    """Build the static descriptor that lets the MAP/conditional-sampling
    routing passes run manually partitioned under ``shard_map``: a
    :class:`cirkit_tpu.backend.jax.queries.TPRouting` (mesh-axis name, shard
    count, per-plan-entry sharded flags) plus the per-slot PartitionSpecs
    matching :func:`shard_store_tp`'s placement. The contractions then see
    only local weight shards, with explicit collectives between them."""
    from cirkit_tpu.backend.jax.queries import TPRouting

    num_shards = mesh.shape[model_axis]
    slot_specs = tp_slot_specs(circuit, num_shards)
    flags = tuple(
        _layer_sharded(entry.layer, slot_specs) for entry in circuit._entries
    )
    specs = {
        name: (
            # store arrays are (F, *slot.shape): axis 1 is the unit axis
            P(*([None, model_axis] + [None] * (len(circuit.slots[name].shape) - 1)))
            if name in slot_specs
            else P()
        )
        for name in circuit.used_slots
        if name in circuit.slots
    }
    return TPRouting(model_axis, num_shards, flags), specs


def _layer_sharded(layer, slot_specs: dict[str, int]) -> bool:
    """Whether the layer's own parameters are unit-sharded."""
    if isinstance(layer, (JaxSumLayer, JaxCPTLayer, JaxTuckerLayer)):
        slots = layer.weight.tensor_slots()
        return len(slots) == 1 and slots[0].slot in slot_specs
    if isinstance(layer, JaxInputLayer) and not isinstance(layer, JaxConstantInputLayer):
        for p in layer.params.values():
            slots = p.tensor_slots()
            if not (len(slots) == 1 and slots[0].slot in slot_specs):
                return False
        return bool(layer.params)
    return False


def _plan_flags(circuit: JaxCircuit, slot_specs: dict[str, int]) -> list[bool]:
    """Static per-plan-entry decision: is the entry's output unit-sharded?"""
    flags: list[bool] = []
    for entry in circuit._entries:
        layer = entry.layer
        if isinstance(layer, JaxHadamardLayer):
            # elementwise over units: sharded iff every input is sharded
            flags.append(bool(entry.in_ids) and all(flags[i] for i in entry.in_ids))
        elif isinstance(layer, JaxKroneckerLayer):
            flags.append(False)  # K^2 outputs mix unit shards
        else:
            flags.append(_layer_sharded(layer, slot_specs))
    return flags


def shard_store_tp(
    circuit: JaxCircuit, store: Store, mesh: Mesh, *, model_axis: str = "model"
) -> tuple[Store, dict[str, P]]:
    """Place a store on the mesh with unit-sharded weights; returns the
    sharded store and the per-slot PartitionSpecs (P() for replicated)."""
    num_shards = mesh.shape[model_axis]
    slot_specs = tp_slot_specs(circuit, num_shards)
    specs: dict[str, P] = {}
    out: Store = {}
    for name, value in store.items():
        if name in slot_specs:
            spec = P(*([None, model_axis] + [None] * (value.ndim - 2)))
        else:
            spec = P()
        specs[name] = spec
        out[name] = jax.device_put(value, NamedSharding(mesh, spec))
    return out, specs


def _tp_forward_local(
    circuit: JaxCircuit,
    flags: list[bool],
    model_axis: str,
    store: Store,
    x: jnp.ndarray,
) -> jnp.ndarray:
    """The per-device forward: runs the plan on local weight shards,
    gathering activations over the model axis where a contraction needs the
    full input-unit axis. Returns the full (B, O, K) output."""

    tmap = jax.tree_util.tree_map

    def gather(y: jnp.ndarray) -> jnp.ndarray:
        return tmap(lambda a: jax.lax.all_gather(a, model_axis, axis=-1, tiled=True), y)

    outs: list[jnp.ndarray] = []
    b = x.shape[0]
    for i, entry in enumerate(circuit._entries):
        layer = entry.layer
        if isinstance(layer, JaxConstantInputLayer):
            y = layer(store, b)
        elif isinstance(layer, JaxInputLayer):
            xin = jnp.transpose(x[:, layer.scope_idx], (1, 0, 2))
            y = layer(store, xin)
        else:
            keep_sharded = isinstance(layer, JaxHadamardLayer) and flags[i]
            ins = []
            for j in entry.in_ids:
                ins.append(outs[j] if (keep_sharded or not flags[j]) else gather(outs[j]))
            cat = ins[0] if len(ins) == 1 else tmap(lambda *a: jnp.concatenate(a, axis=0), *ins)
            fi = entry.fold_idx
            xin = tmap((lambda c: c[:, None]) if fi is None else (lambda c: c[fi]), cat)
            y = layer(store, xin)
        outs.append(y)

    final = [outs[j] if not flags[j] else gather(outs[j]) for j in circuit._outputs.out_ids]
    cat = final[0] if len(final) == 1 else tmap(lambda *a: jnp.concatenate(a, axis=0), *final)
    ofi = circuit._outputs.fold_idx
    raw = cat if ofi is None else tmap(lambda c: c[ofi], cat)
    return tmap(lambda r: jnp.transpose(r, (1, 0, 2)), raw)


def tp_forward(
    circuit: JaxCircuit,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    data_axis: str | None = "data",
) -> Callable[[Store, jnp.ndarray], jnp.ndarray]:
    """A jitted tensor(+data)-parallel forward: ``f(sharded_store, x)``.
    The batch shards over ``data_axis`` (if present in the mesh); weights
    shard per :func:`shard_store_tp`."""
    num_shards = mesh.shape[model_axis]
    slot_specs = tp_slot_specs(circuit, num_shards)
    flags = _plan_flags(circuit, slot_specs)
    store_specs = {
        s: (
            P(*([None, model_axis] + [None] * (len(circuit.slots[s].shape) - 1)))
            if s in slot_specs
            else P()
        )
        for s in circuit.used_slots
        if s in circuit.slots
    }
    batch_spec = P(data_axis) if data_axis and data_axis in mesh.shape else P()

    def fn(store: Store, x: jnp.ndarray) -> jnp.ndarray:
        specs = {s: store_specs.get(s, P()) for s in store}
        mapped = shard_map(
            partial(_tp_forward_local, circuit, flags, model_axis),
            mesh=mesh,
            in_specs=(specs, batch_spec),
            out_specs=batch_spec,
            check_vma=False,
        )
        return mapped(dict(store), x)

    return jax.jit(fn)


def tp_train_step(
    circuit: JaxCircuit,
    optimizer,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    data_axis: str = "data",
    loss_fn: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
) -> Callable:
    """A jitted TPxDP training step ``(trainable, frozen, opt_state, batch)
    -> (trainable, opt_state, loss)``: grads computed under shard_map
    (data-axis pmean everywhere, model-axis psum for replicated slots), the
    optimizer update outside with XLA propagating the shardings."""
    if loss_fn is None:
        loss_fn = lambda ll: -jnp.mean(ll)
    num_shards = mesh.shape[model_axis]
    slot_specs = tp_slot_specs(circuit, num_shards)
    flags = _plan_flags(circuit, slot_specs)

    def spec_of(name: str) -> P:
        if name in slot_specs and name in circuit.slots:
            return P(*([None, model_axis] + [None] * (len(circuit.slots[name].shape) - 1)))
        return P()

    def _local(trainable: Store, frozen: Store, batch: jnp.ndarray):
        def loss(tr: Store) -> jnp.ndarray:
            ll = _tp_forward_local(circuit, flags, model_axis, {**tr, **frozen}, batch)
            return loss_fn(ll)

        l, grads = jax.value_and_grad(loss)(trainable)
        l = jax.lax.pmean(l, data_axis)
        # Every model shard evaluates a full replica of the loss, so the
        # reduce-scatter transposes of the activation all_gathers multiply
        # upstream gradients by the model-axis size; sharded slices divide it
        # out, replicated slots pmean (their per-shard grads carry the same
        # factor through their downstream slice paths).
        grads = {
            k: jax.lax.pmean(
                g / num_shards if k in slot_specs else jax.lax.pmean(g, model_axis),
                data_axis,
            )
            for k, g in grads.items()
        }
        return l, grads

    def build_specs(tree: Store) -> dict[str, P]:
        return {k: spec_of(k) for k in tree}

    def step(trainable: Store, frozen: Store, opt_state, batch):
        mapped = shard_map(
            _local,
            mesh=mesh,
            in_specs=(build_specs(trainable), build_specs(frozen), P(data_axis)),
            out_specs=(P(), build_specs(trainable)),
            check_vma=False,
        )
        loss, grads = mapped(dict(trainable), dict(frozen), batch)
        import optax

        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        return trainable, opt_state, loss

    return jax.jit(step)
