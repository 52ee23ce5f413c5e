"""The folding engine.

Rebuild of ``cirkit/backend/torch/graph/folding.py:17-281`` +
``compiler.py:335-506``. Folding vectorizes the circuit: within each
frontier of the layerwise topological ordering, layers with identical
``fold_settings`` are merged into a single layer with a leading fold axis F,
turning thousands of tiny ops into a few large batched kernels — unfolded
graphs compile to thousands of tiny launches.

Parameter graphs fold node-wise: grouped layers are guaranteed (by their
fold_settings, which embed each parameter graph's structural signature) to
carry isomorphic parameter graphs, so nodes zip by canonical post-order
position. Tensor slots are re-allocated as stacked slots; the compiler state
is updated so references from derived circuits resolve to (slot, fold).
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence

import numpy as np

from cirkit_tpu.backend.jax.layers import JaxEvidenceLayer, JaxInputLayer, JaxLayer
from cirkit_tpu.backend.jax.parameters import (
    JaxParameter,
    JaxParameterNode,
    JaxPointerSlot,
    JaxTensorSlot,
)
from cirkit_tpu.utils.algorithms import layerwise_topological_ordering, node_outgoings

# Allocates a fresh slot name.
SlotAlloc = Callable[[], str]


def fold_parameters(
    graphs: Sequence[JaxParameter],
    alloc_slot: SlotAlloc,
    slot_remap: dict[str, tuple[str, list[int]]],
) -> JaxParameter:
    """Fold structurally-identical parameter graphs into one folded graph.

    ``slot_remap`` records, for every pre-fold slot name, the folded slot it
    now lives in and the fold positions of its original folds (used to
    retarget pointer nodes and the compiler state).
    """
    seqs = [g.canonical_nodes() for g in graphs]
    length = len(seqs[0])
    assert all(len(s) == length for s in seqs), "Parameter graphs must be isomorphic"

    pos_of = [{id(n): i for i, n in enumerate(seq)} for seq in seqs]
    folded: list[JaxParameterNode] = []
    for i in range(length):
        group = [seq[i] for seq in seqs]
        proto = group[0]
        if isinstance(proto, JaxTensorSlot):
            new_slot = alloc_slot()
            inits = [init for n in group for init in n.inits]
            origins = [o for n in group for o in n.origins]
            node = JaxTensorSlot(
                new_slot,
                proto.shape,
                dtype=proto.dtype,
                learnable=proto.learnable,
                inits=inits,
                origins=origins,
                num_folds=len(origins),
            )
            offset = 0
            for n in group:
                slot_remap[n.slot] = (new_slot, list(range(offset, offset + n.num_folds)))
                offset += n.num_folds
        else:
            node = proto.fold(group)
        folded.append(node)

    # Rebuild the edges following graph[0]'s structure.
    in_nodes: dict[JaxParameterNode, list[JaxParameterNode]] = {}
    for i, n0 in enumerate(seqs[0]):
        in_nodes[folded[i]] = [folded[pos_of[0][id(c)]] for c in graphs[0].node_inputs(n0)]
    return JaxParameter(folded, in_nodes, [folded[-1]])


def _fold_layer_group(
    group: Sequence[JaxLayer],
    alloc_slot: SlotAlloc,
    slot_remap: dict[str, tuple[str, list[int]]],
) -> JaxLayer:
    """Merge a group of fold-compatible layers into one folded layer."""
    proto = group[0]
    num_folds = sum(l.num_folds for l in group)
    kwargs = dict(proto.config)
    # Fold each named parameter graph node-wise.
    for name in proto.params:
        kwargs[name] = fold_parameters(
            [l.params[name] for l in group], alloc_slot, slot_remap
        )
    # Fold nested sub-layers recursively (evidence layers).
    if isinstance(proto, JaxEvidenceLayer):
        inner = _fold_layer_group([l.layer for l in group], alloc_slot, slot_remap)
        return JaxEvidenceLayer(
            inner,
            observation=kwargs["observation"],
            num_folds=num_folds,
            semiring=proto.semiring,
        )
    if isinstance(proto, JaxInputLayer):
        scope_idx = np.concatenate([l.scope_idx for l in group], axis=0)
        cls = type(proto)
        # Constant input layers construct their own empty scope index.
        from cirkit_tpu.backend.jax.layers import JaxConstantInputLayer

        if issubclass(cls, JaxConstantInputLayer):
            return cls(**kwargs, num_folds=num_folds, semiring=proto.semiring)
        return cls(scope_idx, **kwargs, num_folds=num_folds, semiring=proto.semiring)
    return type(proto)(**kwargs, num_folds=num_folds, semiring=proto.semiring)


def retarget_pointers(
    layers: Sequence[JaxLayer], slot_remap: Mapping[str, tuple[str, list[int]]]
) -> None:
    """Rewrite pointer nodes whose target slots were merged during folding."""

    def fix(layer: JaxLayer) -> None:
        for p in layer.params.values():
            for node in p.nodes:
                if isinstance(node, JaxPointerSlot) and node.slot in slot_remap:
                    new_slot, positions = slot_remap[node.slot]
                    old_idx = (
                        node.fold_idx
                        if node.fold_idx is not None
                        else np.arange(node.num_folds)
                    )
                    node.slot = new_slot
                    node.fold_idx = np.asarray(
                        [positions[i] for i in old_idx], dtype=np.int32
                    )
        for sub in layer.sub_modules.values():
            fix(sub)

    for layer in layers:
        fix(layer)


def simplify_pointers(layers: Sequence[JaxLayer], slot_folds: Mapping[str, int]) -> None:
    """Drop gathers that select every fold of their target slot in order."""

    def fix(layer: JaxLayer) -> None:
        for p in layer.params.values():
            for node in p.nodes:
                if (
                    isinstance(node, JaxPointerSlot)
                    and node.fold_idx is not None
                    and node.slot in slot_folds
                    and node.num_folds == slot_folds[node.slot]
                    and np.array_equal(node.fold_idx, np.arange(node.num_folds))
                ):
                    node.fold_idx = None
        for sub in layer.sub_modules.values():
            fix(sub)

    for layer in layers:
        fix(layer)


def fold_graph(
    layers: Sequence[JaxLayer],
    in_layers: Mapping[JaxLayer, Sequence[JaxLayer]],
    outputs: Sequence[JaxLayer],
    alloc_slot: SlotAlloc,
) -> tuple[
    list[JaxLayer],
    dict[int, list[list[tuple[int, int]]]],
    list[tuple[int, int]],
    dict[str, tuple[str, list[int]]],
    dict[int, tuple[int, int]],
]:
    """Fold an unfolded (F=1 everywhere) layer graph.

    Returns the folded layer list, per-layer fold-input specs (F x H pairs of
    (producer index, fold within producer)), the output (producer, fold)
    pairs, the slot remapping produced by merging tensor slots, and the
    ``id(original layer) -> (folded index, fold)`` placement map (consumed
    by the compiler to retain a symbolic-layer -> fold mapping for
    readback/pruning)."""
    incomings = lambda l: in_layers.get(l, [])
    outs = node_outgoings(layers, incomings)
    frontiers = layerwise_topological_ordering(
        layers, incomings, lambda l: outs.get(l, [])
    )

    slot_remap: dict[str, tuple[str, list[int]]] = {}
    folded_layers: list[JaxLayer] = []
    fold_inputs: dict[int, list[list[tuple[int, int]]]] = {}
    fold_of: dict[int, tuple[int, int]] = {}  # id(orig layer) -> (folded idx, fold)

    for frontier in frontiers:
        groups: dict[tuple, list[JaxLayer]] = {}
        for l in frontier:
            groups.setdefault(l.fold_settings, []).append(l)
        for group in groups.values():
            folded = _fold_layer_group(group, alloc_slot, slot_remap)
            idx = len(folded_layers)
            folded_layers.append(folded)
            spec: list[list[tuple[int, int]]] = []
            for f, orig in enumerate(group):
                fold_of[id(orig)] = (idx, f)
                spec.append([fold_of[id(c)] for c in incomings(orig)])
            if not isinstance(folded, JaxInputLayer):
                fold_inputs[idx] = spec

    fold_outputs = [fold_of[id(o)] for o in outputs]
    retarget_pointers(folded_layers, slot_remap)
    return folded_layers, fold_inputs, fold_outputs, slot_remap, fold_of
