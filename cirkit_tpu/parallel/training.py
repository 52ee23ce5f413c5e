"""Distributed training over device meshes.

This is a new capability relative to the reference (which is single-device,
see SURVEY.md §2.7): maximum-likelihood training with the batch dimension
sharded over a data mesh axis and parameters replicated. Shardings are
declared with ``jax.sharding.NamedSharding`` and the gradient all-reduce is
inserted by XLA (NCCL collectives on GPUs); no host-side communication code
is needed.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from cirkit_tpu.utils.lazy import LazyModule

# optax is only touched at call time (default optimizer, apply_updates):
# deferred so package import stays off the time-to-first-batch bill
optax = LazyModule("optax", "optax", globals())
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cirkit_tpu.backend.jax.circuit import JaxCircuit

Store = dict[str, jax.Array]


def default_mesh(num_devices: int | None = None, axis: str = "data") -> Mesh:
    """A 1D device mesh over the first ``num_devices`` devices."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis,))


class Preempted(RuntimeError):
    """Raised by a checkpointing trainer after it caught SIGTERM/SIGINT and
    wrote a final checkpoint: the run can be resumed with ``resume=True``.
    Preemptible cloud machines signal eviction with SIGTERM — this is the
    graceful-preemption half of SURVEY §5's failure-detection story."""


class _PreemptionGuard:
    """While active (and in the main thread), SIGTERM/SIGINT set a flag the
    training loop polls instead of killing the process mid-step. Previous
    handlers are restored on exit; a second signal (while flagged) falls
    through to the previous handler so a stuck run can still be killed."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.flag: Any = None
        self._previous: list = []

    def __enter__(self) -> "_PreemptionGuard":
        if not self.enabled:
            return self
        import signal

        def handler(signum, frame):
            if self.flag is not None:  # second signal: don't swallow it
                prev = dict(self._previous).get(signum)
                if callable(prev):
                    prev(signum, frame)
                    return
                raise KeyboardInterrupt
            self.flag = signum

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous.append((sig, signal.signal(sig, handler)))
            except ValueError:  # not the main thread: run unguarded
                pass
        return self

    def __exit__(self, *exc) -> None:
        import signal

        for sig, prev in self._previous:
            signal.signal(sig, prev)


def replicate_store(store: Store, mesh: Mesh) -> Store:
    """Place every parameter replicated across the mesh.

    Always copies: ``device_put`` may alias the source buffer when it is
    already resident, and training steps donate their parameter buffers —
    an alias would invalidate the caller's original store."""
    sharding = NamedSharding(mesh, P())
    return {k: jax.device_put(jnp.array(v), sharding) for k, v in store.items()}


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """Shard the leading (batch) axis of an array over the mesh."""
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(axis)))


def zero1_state_shardings(
    opt_state, mesh: Mesh, *, axis: str = "data"
) -> "jax.tree_util.PyTreeDef":
    """ZeRO-1 placement for an optax state: every array leaf whose leading
    (fold) axis divides the mesh axis is sharded over it; scalars and
    non-divisible leaves stay replicated. Returns a pytree of NamedShardings
    matching ``opt_state``."""
    n = mesh.shape[axis]

    def spec(leaf):
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] % n == 0:
            return NamedSharding(mesh, P(axis))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(spec, opt_state)


def shard_opt_state_zero1(opt_state, mesh: Mesh, *, axis: str = "data"):
    """Place an optax state with ZeRO-1 sharding (see
    :func:`zero1_state_shardings`)."""
    shardings = zero1_state_shardings(opt_state, mesh, axis=axis)
    return jax.tree_util.tree_map(jax.device_put, opt_state, shardings)


def data_parallel_step(
    circuit: JaxCircuit,
    optimizer: optax.GradientTransformation,
    *,
    mesh: Mesh | None = None,
    axis: str = "data",
    loss_fn: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
    weighted: bool = False,
    zero1: bool = False,
    marginalize_missing: bool = False,
    cache_token: str | None = None,
) -> Callable:
    """Build a jitted data-parallel training step.

    ``cache_token`` (single-device steps only): opt into the warm-compile
    cache (``backend/jax/warmcache.py``) — the token must uniquely identify
    the OPTIMIZER (and any custom ``loss_fn``) configuration, which the
    cache cannot fingerprint itself; :func:`fit` passes one automatically
    for its default optimizer. A second process then deserializes the
    compiled step instead of compiling it.

    The step takes ``(trainable, frozen, opt_state, batch)`` and returns
    ``(trainable, opt_state, loss)``. The batch is expected sharded over the
    mesh ``axis``; parameters replicated. The default loss is the mean
    negative log-likelihood of the circuit's (B, O, K) output.

    With ``weighted=True`` the step takes an extra per-sample weight vector
    ``(B,)`` and the default loss becomes the weighted NLL mean — this is how
    :func:`fit` trains a zero-padded final partial batch with exact math
    while keeping shapes (and therefore the compiled program) static.

    With ``marginalize_missing=True`` the step takes a (B, D) boolean mask
    of MISSING entries (after the weights when ``weighted``) and the loss
    becomes the **marginal** negative log-likelihood: masked variables are
    summed out at their input layers (the IntegrateQuery evaluation inside
    the loss), so incomplete rows train on exactly their observed margin —
    principled missing-data MLE, per sample, with no imputation and no
    recompilation across missingness patterns.

    With ``zero1=True`` (requires a mesh) the optimizer state and its update
    computation are sharded over the mesh ``axis`` (ZeRO-1): gradients are
    reduce-scattered onto per-device slices, each device updates 1/N of the
    Adam moments, and the fresh parameters are all-gathered — the state
    memory and the update's HBM traffic (measured ~half of the flagship
    train step, docs/PERF.md) both drop by the mesh size. Pass an opt_state
    placed by :func:`shard_opt_state_zero1`; parameters stay replicated.
    Numerically identical to the plain data-parallel step.
    """

    if weighted and loss_fn is not None:
        raise ValueError("weighted=True supports only the default NLL loss")
    if marginalize_missing and loss_fn is not None:
        raise ValueError("marginalize_missing=True supports only the default NLL loss")

    def _loss(trainable: Store, frozen: Store, batch, weights, missing) -> jnp.ndarray:
        store = {**trainable, **frozen}
        if missing is None:
            ll = circuit.evaluate(store, batch)
        else:
            from cirkit_tpu.backend.jax.queries import masked_evaluate

            ll = masked_evaluate(circuit, store, batch, missing)
        if loss_fn is not None:
            return loss_fn(ll)
        if weights is None:
            return -jnp.mean(ll)
        per_sample = jnp.mean(ll.reshape(ll.shape[0], -1), axis=1)
        # tiny epsilon (not 1.0): fractional weight sums < 1 must still
        # yield the documented sum(w*ll)/sum(w); the numerator is 0
        # whenever the weight sum is 0, so all-padding batches stay safe
        return -jnp.sum(per_sample * weights) / jnp.maximum(
            jnp.sum(weights), 1e-12
        )

    def _step(trainable: Store, frozen: Store, opt_state, batch, weights=None, missing=None):
        loss, grads = jax.value_and_grad(_loss)(
            trainable, frozen, batch, weights, missing
        )
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        return trainable, opt_state, loss

    if mesh is None and zero1:
        raise ValueError("zero1=True requires a device mesh")

    if zero1:
        n = mesh.shape[axis]
        replicated = NamedSharding(mesh, P())

        def _gspec(g):
            if g.ndim >= 1 and g.shape[0] % n == 0:
                return NamedSharding(mesh, P(axis))
            return replicated

        def _step_zero(trainable, frozen, opt_state, batch, weights=None, missing=None):
            loss, grads = jax.value_and_grad(_loss)(
                trainable, frozen, batch, weights, missing
            )
            # reduce-scatter the gradients onto the ZeRO shards ...
            grads = jax.tree_util.tree_map(
                lambda g: jax.lax.with_sharding_constraint(g, _gspec(g)), grads
            )
            updates, opt_state = optimizer.update(grads, opt_state, trainable)
            # ... update 1/N of the moments per device, all-gather the updates
            updates = jax.tree_util.tree_map(
                lambda u: jax.lax.with_sharding_constraint(u, replicated), updates
            )
            trainable = optax.apply_updates(trainable, updates)
            return trainable, opt_state, loss

        _step = _step_zero

    if weighted and marginalize_missing:
        step = lambda tr, fr, st, b, w, m: _step(tr, fr, st, b, w, m)
    elif weighted:
        step = lambda tr, fr, st, b, w: _step(tr, fr, st, b, w)
    elif marginalize_missing:
        step = lambda tr, fr, st, b, m: _step(tr, fr, st, b, None, m)
    else:
        step = lambda tr, fr, st, b: _step(tr, fr, st, b)

    # Donating the parameter and optimizer-state buffers lets XLA update
    # them in place instead of allocating fresh copies every step.
    if mesh is None:
        if cache_token is not None:
            from cirkit_tpu.backend.jax.warmcache import (
                CachedJit,
                circuit_fingerprint,
            )

            return CachedJit(
                step,
                name="train_step",
                key_parts=(
                    circuit_fingerprint(circuit),
                    cache_token,
                    weighted,
                    marginalize_missing,
                ),
                donate_argnums=(0, 2),
            )
        return jax.jit(step, donate_argnums=(0, 2))
    if zero1:
        # opt-state shardings are inherited from the caller's placement
        # (shard_opt_state_zero1); parameters stay replicated.
        return jax.jit(step, donate_argnums=(0, 2))
    replicated = NamedSharding(mesh, P())
    batch_sharded = NamedSharding(mesh, P(axis))
    in_sh = (replicated, replicated, replicated, batch_sharded)
    if weighted:
        in_sh = in_sh + (batch_sharded,)
    if marginalize_missing:
        in_sh = in_sh + (batch_sharded,)
    return jax.jit(
        step,
        in_shardings=in_sh,
        out_shardings=(replicated, replicated, replicated),
        donate_argnums=(0, 2),
    )


def evaluate_ll(
    circuit: JaxCircuit,
    data: np.ndarray | jnp.ndarray,
    *,
    store: Store | None = None,
    batch_size: int = 512,
    mesh: Mesh | None = None,
    axis: str = "data",
) -> float:
    """Mean log-likelihood of a dataset: batched through one jitted program
    (zero-padded weighted final batch, so shapes stay static), optionally
    sharded over a mesh. The library-grade version of the eval loops the
    reference's notebooks hand-roll."""
    if store is None:
        store = getattr(circuit, "default_store", None)
        if store is None:
            raise ValueError("No parameter store bound; pass store=...")
    store = circuit.restrict_store(store)
    data = np.asarray(data)
    if not jax.config.jax_enable_x64:
        if data.dtype == np.int64:
            data = data.astype(np.int32)
        elif data.dtype == np.float64:
            data = data.astype(np.float32)
    if mesh is not None:
        if batch_size % mesh.devices.size != 0:
            raise ValueError("The batch size must divide evenly across the mesh devices")
        store = replicate_store(store, mesh)

    @jax.jit
    def chunk_ll(st, batch, weights):
        ll = circuit.evaluate(st, batch)
        per_sample = jnp.mean(ll.reshape(ll.shape[0], -1), axis=1)
        return jnp.sum(per_sample * weights)

    total = jnp.zeros(())
    for i in range(0, len(data), batch_size):
        batch = data[i : i + batch_size]
        weights = np.ones(batch_size, np.float32)
        if len(batch) < batch_size:
            weights[len(batch) :] = 0.0
            pad = np.zeros((batch_size - len(batch),) + batch.shape[1:], batch.dtype)
            batch = np.concatenate([batch, pad])
        bdev, wdev = jnp.asarray(batch), jnp.asarray(weights)
        if mesh is not None:
            bdev, wdev = shard_batch(bdev, mesh, axis), shard_batch(wdev, mesh, axis)
        total = total + chunk_ll(store, bdev, wdev)
    return float(total) / len(data)


def split_trainable(
    circuit: JaxCircuit,
    store: Store,
    freeze: "str | Iterable[str] | None" = None,
) -> tuple[Store, Store]:
    """Split a store into (trainable, frozen) according to the circuit spec.

    ``freeze`` keeps extra slots fixed: an iterable of slot names, or the
    string ``"shared"`` for every learnable slot the circuit only POINTS
    at (parameter sharing with operand circuits) — e.g. blend-only
    stacking on a ``mixture`` ensemble without touching the trained
    components."""
    learnable = set(circuit.learnable_slots)
    if freeze is not None:
        if isinstance(freeze, str):
            if freeze != "shared":
                raise ValueError(f"freeze must be 'shared' or slot names, got {freeze!r}")
            learnable -= circuit.shared_learnable_slots
        else:
            learnable -= set(freeze)
    used = set(circuit.used_slots)
    trainable = {k: v for k, v in store.items() if k in learnable and k in used}
    frozen = {k: v for k, v in store.items() if k in used and k not in learnable}
    return trainable, frozen


def fit(
    circuit: JaxCircuit,
    data: np.ndarray | jnp.ndarray,
    *,
    store: Store | None = None,
    num_epochs: int = 1,
    batch_size: int = 256,
    optimizer: optax.GradientTransformation | None = None,
    mesh: Mesh | None = None,
    axis: str = "data",
    key: jax.Array | None = None,
    shuffle: bool = True,
    callback: Callable[[int, int, float], Any] | None = None,
    missing: str | float | int | None = None,
    sample_weight: np.ndarray | jnp.ndarray | None = None,
    freeze: str | Iterable[str] | None = None,
    checkpoint_every: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
) -> tuple[Store, list[float]]:
    """Maximum-likelihood training of a compiled circuit.

    ``freeze`` keeps extra learnable slots fixed: slot names, or
    ``"shared"`` for every slot the circuit only points at through an
    operand circuit — blend-only **stacking** on a ``mixture`` ensemble
    (the components stay exactly as trained; omit it to fine-tune them
    jointly).

    A convenience the reference leaves to user-land torch loops
    (SURVEY.md §3.5); here it also shards the batch over a device mesh.
    Returns the updated full store and per-step losses. A trailing partial
    batch is zero-padded to the batch size and trained with per-sample
    weights, so every sample contributes exactly once per epoch while the
    compiled step keeps a single static shape.

    ``missing`` enables principled **missing-data MLE**: pass ``"nan"``
    (float data; NaN entries are missing) or a sentinel value (e.g. ``-1``
    for categorical data). Missing entries are marginalized out of each
    sample's likelihood at its input layers — no imputation — and the
    missingness pattern is a per-batch runtime mask, so one compiled step
    serves every pattern. Losses are then mean *marginal* NLLs (their
    scale shrinks with the number of observed entries).

    ``sample_weight`` (length ``len(data)``, nonnegative) optimizes the
    **weighted** likelihood ``sum_i w_i log p(x_i)``: each step's loss is
    the weight-normalized NLL ``sum w ll / sum w`` over its batch, so an
    integer-weighted run matches training on the correspondingly
    replicated dataset. Weighted datasets are the substrate for boosting,
    importance-sampled corpora and deduplicated data with counts.

    ``checkpoint_every=N`` writes an atomic training checkpoint (params +
    optimizer state + step counter + losses) to ``checkpoint_path`` every N
    steps; ``resume=True`` restores it if present and continues exactly
    where the interrupted run stopped — the batch schedule replays
    deterministically from ``key``, so a resumed run reproduces the
    uninterrupted one (pass the same data/batch_size/key/optimizer).
    """
    if (checkpoint_every is not None or resume) and checkpoint_path is None:
        raise ValueError("checkpoint_every/resume require checkpoint_path")
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    default_optimizer = optimizer is None
    if optimizer is None:
        optimizer = optax.adam(1e-2)
    if store is None:
        store = getattr(circuit, "default_store", None)
        if store is None:
            raise ValueError("No parameter store bound; pass store=...")
    if key is None:
        key = jax.random.PRNGKey(0)

    data = np.asarray(data)
    # Canonicalize wide host dtypes once, before any transfer: without
    # jax_enable_x64 they would otherwise be converted on every transfer.
    if not jax.config.jax_enable_x64:
        if data.dtype == np.int64:
            data = data.astype(np.int32)
        elif data.dtype == np.float64:
            data = data.astype(np.float32)
    if mesh is not None and batch_size % mesh.devices.size != 0:
        raise ValueError("The batch size must divide evenly across the mesh devices")
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

        schedule = np.asarray([len(data), batch_size, int(shuffle)], np.int64)
        data_fp = data_fingerprint(data)
        if sample_weight is not None:
            # resume must replay the same weighted objective
            data_fp = data_fp ^ data_fingerprint(sample_weight)

    trainable, frozen = split_trainable(circuit, store, freeze)
    if mesh is not None:
        trainable = replicate_store(trainable, mesh)
        frozen = replicate_store(frozen, mesh)
    else:
        # the training step donates its parameter buffers; copy so the
        # caller's store stays valid
        trainable = {k: jnp.array(v) for k, v in trainable.items()}
    opt_state = optimizer.init(trainable)
    if mesh is not None:
        # the step's outputs come back replicated: place the fresh state the
        # same way (the step count starts on one device), so the second step
        # does not retrace and compile the whole step again
        opt_state = jax.device_put(opt_state, NamedSharding(mesh, P()))

    start_step = 0
    losses: list[float] = []
    if resume:
        from cirkit_tpu.utils.checkpoint import load_training_state, place_replicated

        restored = load_training_state(
            checkpoint_path,
            like={
                "trainable": trainable,
                "opt_state": opt_state,
                "step": np.int64(0),
                "losses": np.zeros(0),
                "schedule": schedule,
                "data_fp": data_fp,
            },
        )
        if restored is not None:
            if not np.array_equal(restored["schedule"], schedule) or int(
                restored["data_fp"]
            ) != int(data_fp):
                raise ValueError(
                    "Checkpoint was written for a different run: exact resume "
                    "replays the original batch schedule, so data, batch_size "
                    f"and shuffle must match (saved len/batch/shuffle="
                    f"{restored['schedule'].tolist()}, this run="
                    f"{schedule.tolist()})"
                )
            start_step = int(np.asarray(restored["step"]))
            losses = [float(v) for v in np.asarray(restored["losses"]).ravel()]
            trainable = place_replicated(restored["trainable"], mesh)
            opt_state = place_replicated(restored["opt_state"], mesh)
    # A dataset smaller than one batch is itself a "partial batch": pad and
    # weight it like a trailing one instead of silently training zero steps.
    remainder = len(data) % batch_size
    weighted = remainder != 0 or sample_weight is not None
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
    step = data_parallel_step(
        circuit, optimizer, mesh=mesh, axis=axis, weighted=weighted,
        marginalize_missing=miss_all is not None,
        # warm-compile cache: only the default optimizer is identifiable
        # (custom optax chains have no stable fingerprint)
        cache_token="fit:adam:1e-2" if default_optimizer and mesh is None else None,
    )
    ones = np.ones(batch_size, dtype=np.float32)

    # Batches are gathered on the host and sent with an asynchronous
    # device_put (see the prefetch below).
    def host_batches(skip: int = 0):
        """Yield (epoch, host batch, host weights or None, host missing mask
        or None). The first ``skip`` batches (a resume's completed steps) are
        not materialized — the key/permutation evolution still replays."""
        nonlocal key
        seen = 0
        for epoch in range(num_epochs):
            if shuffle:
                key, sub = jax.random.split(key)
                perm = np.asarray(jax.random.permutation(sub, len(data)))
            else:
                perm = np.arange(len(data))
            for b in range(num_batches):
                if seen < skip:
                    seen += 1
                    continue
                seen += 1
                idx = perm[b * batch_size : (b + 1) * batch_size]
                weights = ones if sample_weight is None else sample_weight[idx]
                if len(idx) < batch_size:
                    # zero-pad the final partial batch; pad rows carry weight 0
                    weights = np.concatenate(
                        [weights[: len(idx)],
                         np.zeros(batch_size - len(idx), np.float32)]
                    )
                    idx = np.concatenate(
                        [idx, np.zeros(batch_size - len(idx), idx.dtype)]
                    )
                miss = miss_all[idx] if miss_all is not None else None
                yield epoch, data[idx], (weights if weighted else None), miss

    def to_device(item):
        epoch, batch, weights, miss = item
        if mesh is not None:
            batch = shard_batch(batch, mesh, axis)
            wdev = shard_batch(weights, mesh, axis) if weighted else None
            mdev = shard_batch(miss, mesh, axis) if miss is not None else None
        else:
            batch = jnp.asarray(batch)
            wdev = jnp.asarray(weights) if weighted else None
            mdev = jnp.asarray(miss) if miss is not None else None
        return epoch, batch, wdev, mdev

    num_batches = -(-len(data) // batch_size) if weighted else len(data) // batch_size
    # One-batch prefetch: device_put is asynchronous, so issuing batch i+1's
    # host->device transfer before running step i overlaps it with the
    # step. Losses stay on device during
    # the loop unless a callback needs them: float(loss) every step would
    # re-synchronize the pipeline.
    if start_step > num_epochs * num_batches:
        raise ValueError(
            f"Checkpoint at step {start_step} is beyond this run's "
            f"{num_epochs * num_batches} total steps — resume with the same "
            "(or more) epochs and the same data/batch_size"
        )
    device_losses: list = []
    it = host_batches(skip=start_step)
    pending = next(it, None)
    pending = to_device(pending) if pending is not None else None
    step_idx = start_step

    def save_ck():
        from cirkit_tpu.utils.checkpoint import save_training_state

        losses.extend(float(l) for l in device_losses)
        device_losses.clear()
        save_training_state(
            checkpoint_path,
            {
                "trainable": trainable,
                "opt_state": opt_state,
                "step": np.int64(step_idx),
                "losses": np.asarray(losses, np.float64),
                "schedule": schedule,
                "data_fp": data_fp,
            },
        )

    with _PreemptionGuard(checkpoint_every is not None) as guard:
        while pending is not None:
            epoch, batch, wdev, mdev = pending
            nxt = next(it, None)
            pending = to_device(nxt) if nxt is not None else None
            args = (batch,)
            if weighted:
                args = args + (wdev,)
            if mdev is not None:
                args = args + (mdev,)
            trainable, opt_state, loss = step(trainable, frozen, opt_state, *args)
            if callback is not None:
                loss = float(loss)
                losses.append(loss)
                callback(epoch, step_idx, loss)
            else:
                device_losses.append(loss)
            step_idx += 1
            if guard.flag is not None:
                save_ck()
                raise Preempted(
                    f"fit() caught signal {guard.flag} at step {step_idx}; "
                    f"checkpoint written to {checkpoint_path} — rerun with "
                    "resume=True to continue"
                )
            if (
                checkpoint_every is not None
                and step_idx % checkpoint_every == 0
                and pending is not None  # the final state lands in the return
            ):
                save_ck()
    losses.extend(float(l) for l in device_losses)

    new_store = dict(store)
    new_store.update({k: v for k, v in trainable.items()})
    circuit.default_store = new_store
    return new_store, losses
