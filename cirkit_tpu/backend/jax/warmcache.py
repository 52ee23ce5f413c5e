"""Transparent warm-compile cache: second processes skip compiles.

Every fresh process re-pays the circuit's init/forward/train-step XLA
compiles; the reference, by contrast, re-pays only torch module
construction (~5.4-5.7 s; BASELINE.md row 1). The explicit answer
(:mod:`cirkit_tpu.backend.jax.warmstart`) removes all of it but requires
the user to call ``save_bundle``/``load_bundle``. This module makes it
automatic: the circuit's jit sites consult a disk cache of serialized
executables keyed by (circuit fingerprint, argument shapes,
device/jax/package fingerprint, numerics settings) — a cache hit
deserializes the compiled binary (``jax.experimental.serialize_executable``)
instead of compiling; a miss compiles once and persists.

Off unless ``CIRKIT_TPU_CACHE=<dir>`` names the cache directory. JAX's own
persistent compilation cache (``JAX_COMPILATION_CACHE_DIR``) covers the XLA
compile; this one also skips tracing and lowering.

Safety properties:

- the fingerprint covers everything that shapes the traced program: the
  compiled plan (per-entry layer fold settings, scopes, fold gathers,
  parameter-graph node signatures, slot shapes/dtypes/initializer
  identities), the semiring, argument tree shapes/dtypes, the numerics
  settings (JAX's default matmul precision, x64), jax + package versions,
  and the device fingerprint. An initializer
  without a stable identity poisons its fingerprint with a per-process
  token, so it can never produce a false hit;
- executables are sha256-verified on load, written atomically
  (tmp + rename), and any load failure falls back to a plain compile;
- multi-device/sharded arguments skip the cache (serialized executables
  pin their device assignment; GSPMD/shard_map programs go through their
  own paths anyway).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
import uuid
from pathlib import Path
from typing import Any, Callable

import jax
import numpy as np

_DIR_ENV = "CIRKIT_TPU_CACHE"
_PROCESS_TOKEN = uuid.uuid4().hex  # poisons fingerprints that cannot be stable
# observable cache behavior (tests / diagnostics)
stats = {"hits": 0, "misses": 0}


def cache_dir() -> Path | None:
    """The cache directory, or None when the cache is disabled here."""
    path = os.environ.get(_DIR_ENV)
    return Path(path) if path else None


def _env_fingerprint() -> tuple:
    import cirkit_tpu

    dev = jax.devices()[0]
    return (
        jax.__version__,
        getattr(cirkit_tpu, "__version__", "0"),
        dev.platform,
        getattr(dev, "device_kind", "unknown"),
        bool(jax.config.jax_enable_x64),
        str(jax.config.jax_default_matmul_precision),
    )


def _init_sig(init: Callable) -> Any:
    """A stable identity for a compiled initializer, or a process-unique
    token when none exists (so unknown inits can never falsely cache-hit)."""
    const = getattr(init, "constant", None)
    if const is not None:
        arr = np.asarray(const)
        return ("const", arr.shape, str(arr.dtype), hashlib.sha256(arr.tobytes()).hexdigest())
    bk = getattr(init, "batch_key", None)
    if bk is not None:
        return ("batch", bk)
    return ("opaque", _PROCESS_TOKEN)


def _param_sig(p) -> tuple:
    from cirkit_tpu.backend.jax.parameters import JaxTensorSlot

    sig = []
    for node in p.topological_ordering():
        entry = [type(node).__name__, tuple(node.shape), node.num_folds]
        if isinstance(node, JaxTensorSlot):
            # NOT the generic config: its repr embeds initializer-closure
            # addresses (process-unique); this explicit tuple is canonical
            entry.append((node.slot, str(node.dtype), node.learnable,
                          tuple(_init_sig(i) for i in node.inits)))
        else:
            cfg = getattr(node, "config", None)
            if cfg:
                entry.append(tuple(sorted((k, repr(v)) for k, v in cfg.items())))
        slot = getattr(node, "slot", None)
        if slot is not None and not isinstance(node, JaxTensorSlot):
            fold_idx = getattr(node, "fold_idx", None)
            entry.append((slot, None if fold_idx is None
                          else hashlib.sha256(np.asarray(fold_idx).tobytes()).hexdigest()))
        sig.append(tuple(entry))
    return tuple(sig)


def _layer_sig(layer) -> tuple:
    sig = [type(layer).__name__, layer.num_folds, layer.arity,
           layer.num_input_units, layer.num_output_units]
    cfg = tuple(sorted((k, repr(v)) for k, v in layer.config.items()))
    sig.append(cfg)
    scope = getattr(layer, "scope_idx", None)
    if scope is not None:
        sig.append(hashlib.sha256(np.asarray(scope).tobytes()).hexdigest())
    sig.append(tuple((n, _param_sig(p)) for n, p in sorted(layer.params.items())))
    sig.append(tuple((n, _layer_sig(m)) for n, m in sorted(layer.sub_modules.items())))
    return tuple(sig)


def circuit_fingerprint(circuit) -> str:
    """A sha256 hex digest of everything about the compiled plan that shapes
    its traced programs (layers, parameter graphs, fold gathers, slots,
    initializer identities, semiring). Memoized on the circuit."""
    cached = getattr(circuit, "_warmcache_fp", None)
    if cached is not None:
        return cached
    parts: list[Any] = [circuit.semiring.__name__]
    for entry in circuit._entries:
        idx = entry.fold_idx
        parts.append((
            _layer_sig(entry.layer),
            tuple(entry.in_ids),
            None if idx is None else hashlib.sha256(np.asarray(idx).tobytes()).hexdigest(),
        ))
    out = circuit._outputs
    oidx = out.fold_idx
    parts.append((tuple(out.out_ids),
                  None if oidx is None else hashlib.sha256(np.asarray(oidx).tobytes()).hexdigest()))
    parts.append(tuple(
        (s, tuple(n.shape), n.num_folds, str(n.dtype), n.learnable,
         tuple(_init_sig(i) for i in n.inits))
        for s, n in sorted(circuit.slots.items())
    ))
    fp = hashlib.sha256(repr(parts).encode()).hexdigest()
    if "opaque" not in repr(parts):
        circuit._warmcache_fp = fp
    return fp


def _args_sig(args: tuple) -> str:
    leaves, treedef = jax.tree_util.tree_flatten(args)
    sig = [str(treedef)]
    for leaf in leaves:
        sig.append(f"{getattr(leaf, 'shape', ())}:{getattr(leaf, 'dtype', type(leaf).__name__)}")
    return hashlib.sha256("|".join(sig).encode()).hexdigest()


def _cacheable_args(args: tuple) -> bool:
    """Serialized executables pin a single-device (device 0) assignment:
    skip the cache for sharded inputs or arrays committed to another device
    (their programs go through GSPMD/shard_map paths anyway)."""
    dev0 = jax.devices()[0]
    for leaf in jax.tree_util.tree_leaves(args):
        sharding = getattr(leaf, "sharding", None)
        if sharding is None:
            continue  # host value: placed by the executable itself
        try:
            if set(sharding.device_set) != {dev0}:
                return False
        except Exception:
            return False
    return True


class CachedJit:
    """A ``jax.jit`` whose per-shape executables round-trip through the disk
    cache. Call it exactly like the jitted function."""

    def __init__(
        self,
        fn: Callable,
        *,
        name: str,
        key_parts: tuple = (),
        donate_argnums: tuple = (),
    ):
        self._jit = jax.jit(fn, donate_argnums=donate_argnums)
        self._name = name
        self._key_parts = (*key_parts, donate_argnums)
        self._mem: dict[str, Callable] = {}

    def __call__(self, *args, **kwargs):
        # kwargs ride the same path: the signature hash covers the full
        # (args, kwargs) tree, and lower/call use the identical convention
        # so the serialized in_tree matches (each call site is consistent)
        root = cache_dir()
        if root is None or not _cacheable_args((args, kwargs)):
            return self._jit(*args, **kwargs)
        akey = _args_sig((args, kwargs))
        fn = self._mem.get(akey)
        if fn is None:
            key = hashlib.sha256(
                repr((self._name, self._key_parts, _env_fingerprint(), akey)).encode()
            ).hexdigest()
            fn = _load_or_compile(root, key, self._jit, args, kwargs, self._name)
            self._mem[akey] = fn
        return fn(*args, **kwargs)


def _load_or_compile(
    root: Path, key: str, jitted, args: tuple, kwargs: dict, name: str
) -> Callable:
    from jax.experimental import serialize_executable as se

    path = root / key[:2] / f"{key}.jaxexec"
    meta = path.with_suffix(".json")
    if path.is_file() and meta.is_file():
        try:
            blob = path.read_bytes()
            m = json.loads(meta.read_text())
            if hashlib.sha256(blob).hexdigest() == m.get("sha256"):
                payload = pickle.loads(blob)
                loaded = se.deserialize_and_load(
                    *payload, execution_devices=jax.devices()[:1]
                )
                stats["hits"] += 1
                return loaded
        except Exception:
            pass  # corrupt / incompatible entry: recompile and overwrite
    stats["misses"] += 1
    compiled = jitted.lower(*args, **kwargs).compile()
    try:
        payload = se.serialize(compiled)
        blob = pickle.dumps(payload)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        fdm, tmpm = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        with os.fdopen(fdm, "w") as f:
            json.dump({"sha256": hashlib.sha256(blob).hexdigest(), "name": name}, f)
        os.replace(tmpm, meta)
    except Exception:
        pass  # a cache-write failure must never break the computation
    return compiled
