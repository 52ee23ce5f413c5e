"""Serving-store utilities: bf16-resident weights for inference.

The flagship forward pass reads ~1.6 GB of sum-style weights (the Tucker
cores of the MNIST QuadGraph K=64 circuit) per batch. Storing those weights
in bfloat16 halves that stream; the contractions (ops/lse_einsum.py)
promote bf16 weights to f32 and normalize softmax rows in f32, so only the
initial rounding changes.

This is an inference-oriented transform: keep training in f32 and cast a
copy for serving. Gradients through a bf16 store work (dL/dw accumulates in
f32 and is cast at the boundary) but are rounded.
"""

from __future__ import annotations

import jax.numpy as jnp

from cirkit_tpu.backend.jax.circuit import JaxCircuit
from cirkit_tpu.backend.jax.layers import JaxSumLayer
from cirkit_tpu.backend.jax.optimized import (
    JaxCPTLayer,
    JaxTensorDotLayer,
    JaxTuckerLayer,
)
from cirkit_tpu.backend.jax.parameters import (
    JaxMixingWeightParameter,
    JaxTensorSlot,
    Store,
)


def weight_slots(circuit: JaxCircuit) -> set[str]:
    """The store slots streamed as sum-style contraction weights: softmax
    logits slots (the layers' fused parameterization) and plain weight
    slots, for dense/mixing/fused Tucker/CPT/TensorDot layers."""
    slots: set[str] = set()
    for layer in circuit.layers:
        if not isinstance(
            layer, (JaxSumLayer, JaxCPTLayer, JaxTuckerLayer, JaxTensorDotLayer)
        ):
            continue
        if getattr(layer, "_logits_slot", None) is not None:
            slots.add(layer._logits_slot)
            continue
        # only slots the contractions read *directly* (bare weights or a 0/1
        # MixingWeight placement): casting a slot feeding e.g. an Exp
        # reparameterization would amplify the rounding through the map
        nodes = list(layer.weight.topological_ordering())
        if len(nodes) == 1 and isinstance(nodes[0], JaxTensorSlot):
            slots.add(nodes[0].slot)
        elif (
            len(nodes) == 2
            and isinstance(nodes[0], JaxTensorSlot)
            and isinstance(nodes[1], JaxMixingWeightParameter)
        ):
            slots.add(nodes[0].slot)
    return slots


def bf16_weight_store(circuit: JaxCircuit, store: Store) -> Store:
    """A copy of ``store`` with the circuit's contraction-weight slots cast
    to bfloat16: round-to-nearest-bf16 weight grade (~4e-3 worst case)
    while halving the weight bytes; all other slots keep their dtype."""
    slots = weight_slots(circuit)
    return {
        k: (jnp.asarray(v).astype(jnp.bfloat16) if k in slots else v)
        for k, v in store.items()
    }


def export_circuit(
    circuit: JaxCircuit,
    x,
    *,
    store: Store,
    query: str = "evaluate",
    platforms=None,
) -> bytes:
    """Serialize the circuit's forward as a portable StableHLO artifact
    (``jax.export``): a production-serving handoff the reference has no
    analogue of (its serving story is pickling torch modules). The
    artifact is self-contained MLIR with a versioned calling convention —
    loadable from any jax process (or XLA runtime) WITHOUT cirkit-tpu
    installed, and replayable on new parameter stores of the same shapes
    (the store is an argument, not baked in, so artifacts stay small and
    checkpoint swaps need no re-export).

    ``query="evaluate"`` exports ``(store, x) -> (B, O, K)`` log-densities;
    ``query="integrate"`` exports ``(store, x, mask) -> (B, O, K)``
    per-sample marginals (the :func:`masked_evaluate` program — runtime
    evidence masks ride along into serving). ``x`` fixes the batch
    shape/dtype. ``platforms`` defaults to the tracing backend; pass e.g.
    ``platforms=("cpu", "cuda")`` for an artifact that runs on both."""
    import jax
    from jax import export as jax_export

    from cirkit_tpu.backend.jax.queries import masked_evaluate

    restricted = circuit.restrict_store(store)
    x = jnp.asarray(x)
    spec = lambda v: jax.ShapeDtypeStruct(jnp.shape(v), jnp.asarray(v).dtype)
    store_spec = {k: spec(v) for k, v in restricted.items()}
    if query == "evaluate":
        fn = jax.jit(lambda st, xx: circuit.evaluate(st, xx))
        args = (store_spec, spec(x))
    elif query == "integrate":
        fn = jax.jit(lambda st, xx, mk: masked_evaluate(circuit, st, xx, mk))
        mask_spec = jax.ShapeDtypeStruct((x.shape[0], x.shape[1]), jnp.bool_)
        args = (store_spec, spec(x), mask_spec)
    else:
        raise ValueError(f"Unknown query to export: {query!r}")
    kwargs = {} if platforms is None else {"platforms": tuple(platforms)}
    exported = jax_export.export(fn, **kwargs)(*args)
    return bytes(exported.serialize())


def load_exported(data: bytes):
    """Rehydrate an :func:`export_circuit` artifact into a callable with
    the exported signature (``(store, x)`` or ``(store, x, mask)``). Works
    in any jax process; the module's StableHLO is recompiled for the local
    backend on first call."""
    from jax import export as jax_export

    return jax_export.deserialize(bytearray(data)).call
