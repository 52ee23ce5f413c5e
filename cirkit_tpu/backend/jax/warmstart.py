"""AOT warm-start bundles: zero-retrace, zero-recompile process startup.

Cold start pays three costs on every process: Python circuit construction +
plan compilation (~seconds at flagship scale), the parameter-init XLA
program compile, and the forward-program compile (JAX's persistent
compilation cache can skip the last two, not the tracing and lowering).
The reference's corresponding figure — symbolic build + torch compile of the
MNIST QuadGraph circuit — is ~5.4-5.7 s (ref:
``notebooks/compilation-options.ipynb``; BASELINE.md).

A warm bundle removes ALL of it. On the first (cold) build we AOT-compile
the circuit's programs (``jax.jit(fn).lower(args).compile()``) and persist
the *compiled executables* with :mod:`jax.experimental.serialize_executable`
— the serialized artifact embeds the backend binary, so a later process
deserializes and calls with no tracing and no XLA compile at all.

Parameters are NOT stored in the bundle: a flagship-scale store is 1.7 GB,
so the bundle carries the circuit's *init program* (seed -> store, drawn
on device) plus an npz of the constant slots (tiny). Serving trained
weights warm therefore means either (a) training in the same process, or
(b) an npz checkpoint upload, whose cost is the host->device copy, not a
compile.

Executable artifacts are backend-binary-specific: the manifest records the
jax version and device kind, and :func:`load_bundle` raises
:class:`WarmStartError` on any mismatch so callers fall back to the cold
build path.

The reference has no analogue (its compile cost is paid on every process;
``cirkit/pipeline.py`` rebuilds torch modules from the symbolic graph each
time). For cross-platform *portable* artifacts (StableHLO, compiled on
load) see :func:`cirkit_tpu.backend.jax.serving.export_circuit` — the two
trade portability against startup time.
"""

from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import Any, Callable, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.circuit import JaxCircuit
from cirkit_tpu.backend.jax.parameters import Store

_MANIFEST = "manifest.json"
_CONSTS = "consts.npz"


class WarmStartError(RuntimeError):
    """The bundle cannot serve this process (missing / incompatible)."""


def _device_fingerprint() -> dict[str, str]:
    import cirkit_tpu

    dev = jax.devices()[0]
    return {
        "jax": jax.__version__,
        # serialized executables bake in cirkit-tpu semantics (e.g. the
        # 0.1.1 sum-collapsed MAP/top-k routing fix): a bundle built by an
        # older package must not serve a newer one (mirrors warmcache.py's
        # version key)
        "cirkit_tpu": getattr(cirkit_tpu, "__version__", "0"),
        "platform": dev.platform,
        "device_kind": getattr(dev, "device_kind", str(dev)),
    }


def _aot_serialize(fn: Callable, *args: Any) -> tuple[tuple, int]:
    """Trace + compile ``fn`` for ``args`` (shape/dtype specs or concrete
    values) and serialize the compiled executable. Also returns the number
    of devices the executable was compiled for: ``deserialize_and_load``
    defaults to the whole local device set, which breaks a single-device
    program in a multi-device process (e.g. the virtual 8-CPU test mesh)."""
    from jax.experimental import serialize_executable as se

    # already-jitted callables (e.g. data_parallel_step programs) lower
    # directly, preserving their donation annotations; re-wrapping them in
    # an outer jit would inline the inner call and drop donation
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    compiled = jitted.lower(*args).compile()
    try:
        num_devices = len(compiled._executable.xla_executable.local_devices())
    except AttributeError:
        num_devices = 1
    return se.serialize(compiled), num_devices


def _spec(v: Any) -> jax.ShapeDtypeStruct:
    return jax.ShapeDtypeStruct(jnp.shape(v), jnp.asarray(v).dtype)


def _split_const_slots(circuit: JaxCircuit) -> tuple[list[str], list[str]]:
    const, random = [], []
    for s in sorted(circuit.slots):
        node = circuit.slots[s]
        if all(getattr(init, "constant", None) is not None for init in node.inits):
            const.append(s)
        else:
            random.append(s)
    return const, random


def _init_fn(circuit: JaxCircuit, random_slots: tuple[str, ...]) -> Callable:
    """``(key_data u32[2]) -> {slot: array}`` — every random slot drawn on
    device in one program, under the rbg PRNG (see
    JaxCircuit.initialize)."""

    def fn(key_data: jnp.ndarray) -> dict[str, jnp.ndarray]:
        k = jax.random.wrap_key_data(jnp.tile(key_data, 2), impl="rbg")
        ks = jax.random.split(k, len(random_slots))
        return {
            s: circuit.slots[s].initialize(ks[i])
            for i, s in enumerate(random_slots)
        }

    return fn


def save_bundle(
    path: str | os.PathLike,
    circuit: JaxCircuit,
    *,
    store: Store,
    batch: int,
    x_dtype: Any = jnp.int32,
    with_integrate: bool = False,
    extra_programs: Mapping[str, tuple[Callable, tuple]] | None = None,
) -> dict:
    """Persist a warm-start bundle for ``circuit`` at ``path``.

    Contents: the AOT-compiled ``init`` program (seed -> full random store),
    the ``evaluate`` forward at batch size ``batch``, optionally the masked
    ``integrate`` program, any ``extra_programs`` (``name -> (fn,
    example_args)`` — args may be concrete values or ShapeDtypeStructs),
    an npz of constant slots, and a manifest. ``store`` supplies the slot
    shapes/dtypes the forward is compiled against (values are not saved).

    Returns the manifest dict.
    """
    path = Path(path)
    external = set(circuit.used_slots) - set(circuit.slots)
    if external:
        # operator-derived circuits (e.g. multiply(sc, sc)) evaluate through
        # pointer slots whose target tensors belong to the SOURCE circuit —
        # this circuit cannot re-draw them, so a bundle's init() would hand
        # evaluate an incomplete store. Fail at save time, not in the warm
        # process.
        raise WarmStartError(
            "save_bundle cannot bundle an operator-derived circuit: slots "
            f"{sorted(external)} are owned by its source circuit(s). Bundle "
            "the source circuit (and apply the operator in the warm process), "
            "or export with export_circuit, which takes the store at call "
            "time."
        )
    path.mkdir(parents=True, exist_ok=True)
    restricted = circuit.restrict_store(store)
    const_slots, random_slots = _split_const_slots(circuit)

    # constants: tiny, materialized host-side, shipped in the bundle
    np.savez(
        path / _CONSTS,
        **{s: np.asarray(circuit.slots[s].initialize(None)) for s in const_slots},
    )

    store_spec = {k: _spec(v) for k, v in restricted.items()}
    num_vars = circuit.num_variables
    x_spec = jax.ShapeDtypeStruct((batch, num_vars), jnp.dtype(x_dtype))

    programs: dict[str, tuple[Callable, tuple]] = {}
    programs["init"] = (
        _init_fn(circuit, tuple(random_slots)),
        (jax.ShapeDtypeStruct((2,), jnp.uint32),),
    )
    programs["evaluate"] = (
        lambda st, xx: circuit.evaluate(st, xx),
        (store_spec, x_spec),
    )
    if with_integrate:
        from cirkit_tpu.backend.jax.queries import masked_evaluate

        mask_spec = jax.ShapeDtypeStruct((batch, num_vars), jnp.bool_)
        programs["integrate"] = (
            lambda st, xx, mk: masked_evaluate(circuit, st, xx, mk),
            (store_spec, x_spec, mask_spec),
        )
    if extra_programs:
        programs.update(extra_programs)

    saved = []
    program_devices: dict[str, int] = {}
    program_sha256: dict[str, str] = {}
    for name, (fn, args) in programs.items():
        if name == "init":
            # force the traced (device) initializer path: the host (numpy)
            # samplers cannot run under tracing, and a bundle's init must
            # be a pure program
            prev = os.environ.get("CIRKIT_TPU_DEVICE_INIT")
            os.environ["CIRKIT_TPU_DEVICE_INIT"] = "1"
            try:
                payload, ndev = _aot_serialize(fn, *args)
            finally:
                if prev is None:
                    os.environ.pop("CIRKIT_TPU_DEVICE_INIT", None)
                else:
                    os.environ["CIRKIT_TPU_DEVICE_INIT"] = prev
        else:
            payload, ndev = _aot_serialize(fn, *args)
        import hashlib

        blob = pickle.dumps(payload)
        (path / f"{name}.jaxexec.pkl").write_bytes(blob)
        saved.append(name)
        program_devices[name] = ndev
        program_sha256[name] = hashlib.sha256(blob).hexdigest()

    manifest = {
        **_device_fingerprint(),
        "batch": batch,
        "num_variables": num_vars,
        "x_dtype": str(jnp.dtype(x_dtype)),
        "programs": saved,
        "program_devices": program_devices,
        "program_sha256": program_sha256,
        "const_slots": const_slots,
        "random_slots": random_slots,
        "store_spec": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in store_spec.items()
        },
    }
    (path / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


class WarmBundle:
    """A loaded warm-start bundle: compiled programs, no cirkit compile.

    ``init(seed)`` draws the full parameter store on device; ``evaluate``
    / ``integrate`` / any extra programs are exposed under
    :attr:`programs` and as attributes.
    """

    def __init__(self, manifest: dict, programs: dict[str, Callable], consts: dict):
        self.manifest = manifest
        self.programs = programs
        self._consts = consts
        for name, fn in programs.items():
            if name != "init" and not hasattr(self, name):
                setattr(self, name, fn)

    def init(self, seed: int | jnp.ndarray = 0) -> dict[str, jnp.ndarray]:
        """A freshly-initialized full store (random slots drawn on device by
        the bundled program; constant slots uploaded from the bundle).

        Deliberately compile-free: transfers go through ``jax.device_put``,
        never eager jnp ops — every eager op is a program compile, which
        would defeat the warm start."""
        if isinstance(seed, (int, np.integer)):
            key_data = np.array([0, np.uint32(seed)], dtype=np.uint32)
        else:
            key_data = np.asarray(seed, np.uint32)
        store = dict(self.programs["init"](jax.device_put(key_data)))
        store.update({k: jax.device_put(v) for k, v in self._consts.items()})
        return store


def load_bundle(path: str | os.PathLike) -> WarmBundle:
    """Load a :func:`save_bundle` artifact. Raises :class:`WarmStartError`
    if the bundle is absent or was built for a different jax version /
    device kind (executables embed backend binaries) — catch it and fall
    back to the cold build path."""
    from jax.experimental import serialize_executable as se

    path = Path(path)
    mpath = path / _MANIFEST
    if not mpath.is_file():
        raise WarmStartError(f"No warm-start bundle at {path}")
    manifest = json.loads(mpath.read_text())
    fp = _device_fingerprint()
    for field in ("jax", "cirkit_tpu", "platform", "device_kind"):
        if manifest.get(field) != fp[field]:
            raise WarmStartError(
                f"Warm-start bundle {field} mismatch: bundle was built for "
                f"{manifest.get(field)!r}, this process runs {fp[field]!r}; "
                "rebuild cold and re-save."
            )
    import hashlib

    devices = jax.devices()
    programs: dict[str, Callable] = {}
    for name in manifest["programs"]:
        blob = (path / f"{name}.jaxexec.pkl").read_bytes()
        expected = manifest.get("program_sha256", {}).get(name)
        if expected is not None and hashlib.sha256(blob).hexdigest() != expected:
            raise WarmStartError(
                f"Warm-start program {name!r} is corrupt (sha256 mismatch — "
                "truncated write or modified file); rebuild cold and re-save."
            )
        payload = pickle.loads(blob)
        ndev = manifest.get("program_devices", {}).get(name, 1)
        if ndev > len(devices):
            raise WarmStartError(
                f"Warm-start program {name!r} was compiled for {ndev} devices "
                f"but this process has {len(devices)}."
            )
        try:
            programs[name] = se.deserialize_and_load(
                *payload, execution_devices=devices[:ndev]
            )
        except Exception as exc:  # backend rejected the binary
            raise WarmStartError(
                f"Warm-start program {name!r} failed to load on this "
                f"backend: {exc}"
            ) from exc
    consts_path = path / _CONSTS
    consts: dict[str, np.ndarray] = {}
    if consts_path.is_file():
        with np.load(consts_path) as z:
            consts = {k: z[k] for k in z.files}
    return WarmBundle(manifest, programs, consts)
