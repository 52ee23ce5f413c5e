"""Checkpointing for parameter stores and training state.

The JAX replacement for the reference's ``torch.save(state_dict)``
round-trip (ref: ``tests/backend/torch/test_serialization.py:17-32``): a
compiled circuit's entire mutable state is a flat pytree (the parameter
store, and optionally optimizer state / QPC network parameters), so
checkpointing is pytree serialization. Two interchangeable backends:

- :func:`save_store` / :func:`load_store` — single-file ``.npz`` with a
  JSON tree manifest; dependency-free, portable, synchronous. Nested
  pytrees (optimizer states, PIC network params) are flattened with
  ``jax.tree_util`` key paths.
- :func:`save_checkpoint` / :func:`load_checkpoint` — orbax-backed
  directory checkpoints for large, sharded, async-friendly use (multi-host
  runs restore with the same sharding the arrays were saved with).

Structure (region graphs, symbolic circuits) persists separately via
``RegionGraph.dump``/``load`` JSON, mirroring the reference.
"""

from __future__ import annotations

import json
from os import PathLike
from typing import Any

import jax
import numpy as np


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = json.dumps([_path_entry(p) for p in path])
        arr = np.asarray(leaf)
        if arr.dtype.kind == "V":  # ml_dtypes (bfloat16, ...): not npz-native
            arr = arr.astype(np.float32)  # lossless widening; load_store
            flat[key] = arr  # casts back to ``like``'s dtype on restore
        else:
            flat[key] = arr
    return flat


def _path_entry(p) -> list:
    if isinstance(p, jax.tree_util.DictKey):
        return ["d", p.key]
    if isinstance(p, jax.tree_util.SequenceKey):
        return ["s", p.idx]
    if isinstance(p, jax.tree_util.GetAttrKey):
        return ["a", p.name]
    raise TypeError(f"Unsupported pytree path entry {p!r}")


def save_store(path: str | PathLike[str], tree: Any) -> None:
    """Serialize a pytree of arrays (parameter store, optimizer state, ...)
    to a single ``.npz`` file."""
    np.savez(path, **_flatten(tree))


def load_store(path: str | PathLike[str], like: Any | None = None) -> Any:
    """Load a pytree saved by :func:`save_store`. Leaves come back as numpy
    arrays (pass through ``jax.device_put`` / shard as needed).

    Without ``like``, structure is rebuilt from the stored key paths as
    plain dicts/lists — tuples, namedtuples and custom nodes (e.g. optax
    optimizer states) degrade to lists. Pass ``like`` (a pytree with the
    desired structure, such as ``optimizer.init(params)``) to restore the
    exact treedef: leaves are matched to ``like``'s key paths and
    unflattened into its structure."""
    with np.load(path, allow_pickle=False) as data:
        items = [(json.loads(k), data[k]) for k in data.files]

    if like is not None:
        stored = {json.dumps(p): v for p, v in items}
        paths_and_leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
        leaves = []
        for path_entries, like_leaf in paths_and_leaves:
            key = json.dumps([_path_entry(p) for p in path_entries])
            if key not in stored:
                raise KeyError(
                    f"Checkpoint {path!s} has no entry for pytree path {key}"
                )
            value = stored[key]
            # non-npz-native dtypes (e.g. bf16 optimizer moments) were saved
            # widened to float32; restore the target leaf's dtype
            like_dtype = getattr(like_leaf, "dtype", None)
            if like_dtype is not None and value.dtype != like_dtype:
                value = value.astype(like_dtype)
            leaves.append(value)
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def insert(container, path, value):
        kind, key = path[0]
        if kind == "s":
            key = int(key)
            while len(container) <= key:
                container.append(None)
        if len(path) == 1:
            container[key] = value
            return
        nxt = container[key] if isinstance(container, list) else container.get(key)
        if not isinstance(nxt, (dict, list)):
            nxt = [] if path[1][0] == "s" else {}
            container[key] = nxt
        insert(nxt, path[1:], value)

    if not items:
        return {}
    root: Any = [] if items[0][0] and items[0][0][0][0] == "s" else {}
    for path, value in items:
        if not path:
            return value
        insert(root, path, value)
    return root


def save_training_state(path: str | PathLike[str], tree: Any) -> None:
    """Atomically serialize a training-state pytree to ``path`` (an ``.npz``
    file; the suffix is appended if missing): written to a temp file first,
    then ``os.replace``d, so a run killed mid-write never corrupts the last
    good checkpoint. Used by ``fit``/``fit_em``/``grow_prune_loop``'s
    ``checkpoint_every``/``resume`` arguments (SURVEY §5 checkpoint/resume;
    the reference has no trainers, ref ``backend/torch/queries.py:19``)."""
    import os

    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def training_state_path(path: str | PathLike[str]) -> str:
    """The canonical on-disk file for :func:`save_training_state`."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def load_training_state(path: str | PathLike[str], like: Any) -> Any | None:
    """Restore a :func:`save_training_state` checkpoint, or ``None`` when no
    file exists at (the canonicalized) ``path``. One pass over the file:
    include the metadata leaves (step counters, loss arrays) in ``like`` —
    their ``like`` values only fix dtypes, stored shapes win — so the
    GB-scale parameter entries are not read twice. Leaves come back as
    numpy; callers place them (``place_replicated`` for the mesh case)."""
    import os

    file = training_state_path(path)
    if not os.path.exists(file):
        return None
    return load_store(file, like=like)


def data_fingerprint(data: np.ndarray) -> np.uint64:
    """A cheap identity check for trainer resume: shape/dtype plus a CRC of
    the first and last megabyte. Exact-resume semantics require replaying
    the same batch schedule over the same data; this catches the honest
    mistakes (different file, different preprocessing, truncated array)
    without hashing multi-GB datasets."""
    import zlib

    data = np.ascontiguousarray(data)
    raw = data.view(np.uint8).reshape(-1)
    head = raw[: 1 << 20].tobytes()
    tail = raw[-(1 << 20):].tobytes()
    meta = f"{data.shape}{data.dtype}".encode()
    return np.uint64(zlib.crc32(tail, zlib.crc32(head, zlib.crc32(meta))))


def place_replicated(tree: Any, mesh: Any | None = None) -> Any:
    """Put every array leaf on device — replicated over ``mesh`` when given
    (the placement trainer checkpoints restore with)."""
    import jax.numpy as jnp

    if mesh is None:
        return jax.tree_util.tree_map(jnp.asarray, tree)
    from jax.sharding import NamedSharding, PartitionSpec

    sharding = NamedSharding(mesh, PartitionSpec())
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(jnp.asarray(leaf), sharding), tree
    )


def save_checkpoint(path: str | PathLike[str], tree: Any) -> None:
    """Save a pytree as an orbax directory checkpoint (sharded arrays are
    written distributed and restored with their sharding)."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    from pathlib import Path

    ckptr.save(Path(path).absolute(), tree)
    ckptr.wait_until_finished()


def load_checkpoint(path: str | PathLike[str], like: Any | None = None) -> Any:
    """Restore an orbax checkpoint; ``like`` (a matching pytree of arrays or
    ShapeDtypeStructs) restores with its structure/sharding when given."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    from pathlib import Path

    if like is None:
        return ckptr.restore(Path(path).absolute())
    return ckptr.restore(Path(path).absolute(), target=like)


def save_circuit(path: str | PathLike[str], sc: Any) -> None:
    """Persist a symbolic circuit's STRUCTURE + (constant) parameters.

    Closes the persistence gap for circuits that no template rebuilds —
    LearnSPN outputs (``models.learn_spn``), pruned circuits
    (``prune_circuit``), hand-built structures. The format is a versioned
    pickle of the layer graph (layers, parameter graphs with their shared
    references, constant initializers) — an extension; the reference
    persists only region graphs. For template circuits prefer the
    portable ``RegionGraph.dump`` + ``Parameterization`` route.

    Trained TEMPLATE parameters live in the store, not the symbolic
    circuit: persist them alongside with :func:`save_store`. Slot names
    are allocated deterministically per compile order, so a reloaded
    circuit compiled FIRST in a fresh context resolves the same slots
    (pinned in tests/test_serialization_io.py).

    Note the usual pickle caveat: only load circuit files you trust.
    """
    import pickle

    with open(path, "wb") as f:
        pickle.dump({"format": "cirkit-tpu-circuit", "version": 1, "circuit": sc}, f)


def load_circuit(path: str | PathLike[str]) -> Any:
    """Load a symbolic circuit saved by :func:`save_circuit`."""
    import pickle

    try:
        with open(path, "rb") as f:
            blob = pickle.load(f)
    except pickle.UnpicklingError as exc:
        raise ValueError(f"{path} is not a cirkit-tpu circuit file") from exc
    if not (isinstance(blob, dict) and blob.get("format") == "cirkit-tpu-circuit"):
        raise ValueError(f"{path} is not a cirkit-tpu circuit file")
    return blob["circuit"]
