"""GPU smoke test: the flagship's main paths, end to end, on one NVIDIA GPU.

The flagship is the benchmark's headline circuit: MNIST-shaped QuadGraph,
Categorical inputs, Tucker sum-products, K=64 (about 421M parameters),
folded and optimized, evaluated in log space. Weights are drawn from a
seed on the device; data are seeded random pixels.

Phases, each a function of its sizes (the CPU tests call them tiny):

1. device: platform, card name and power limit, versions, caches;
2. forward: the flagship and the CP K=64 forward; the flagship against a
   float64 CPU reference at the DEFAULT, HIGH and HIGHEST dot precisions,
   a bf16 control and the program default, and its gradient at the program
   default; memory analysis and the top device ops;
3. training: Adam and ``adam_lowmem`` steps on a one-device mesh, then
   two EM epochs;
4. queries: integrate, MAP with evidence, conditional sampling;
5. squared circuits: signed against complex log-semiring evaluation;
6. warm start: ``save_bundle`` then ``load_bundle`` in one process.

``--four`` runs only the multi-GPU phase on four cards: data-parallel,
ZeRO-1 and tensor x data parallel training steps and tensor-parallel
MAP/sampling, each checked against the same work on one card.

Run: ``python chip_smoke.py`` (one GPU) or ``python chip_smoke.py --four``.
Without a GPU it exits non-zero and prints no result. The last line of a
passing run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from collections import defaultdict

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Largest relative error of the flagship's per-sample log-likelihood, against
# the float64 reference, that the program's default dot precision may make.
# On an H100 TF32 misses by 4.3e-6 and a bf16 control by 1.3e-5 (PERF.md,
# "Precision"): the limit sits between them, so a slide to bf16 fails.
LL_REL_TOL = 8e-6
# Largest relative L2 error of the gradient of the mean log-likelihood, over
# the whole store, against the float64 gradient. TF32 makes 1.7e-4 and the
# bf16 control 1.4e-3 (PERF.md, "Precision"). Entry by entry the error is
# no measure: near the root the float64 gradient is below 1e-12, under the
# float32 resolution of a log-likelihood near -4000.
GRAD_REL_TOL = 5e-4
# The control run: bf16 products with f32 accumulation, one step below TF32.
BF16_CONTROL = "BF16_BF16_F32"


@dataclasses.dataclass(frozen=True)
class Sizes:
    side: int = 28  # image side of the flagship (MNIST)
    units: int = 64  # sum and input units per layer
    batch: int = 128
    ref_batch: int = 8  # samples checked against the float64 reference
    sos_side: int = 12  # the squared-circuit benchmark configuration
    sos_units: int = 32
    train_steps: int = 5
    warm_side: int = 8  # the warm-start bundle's small circuit
    warm_units: int = 8
    iters: int = 10  # timed calls per round


class SmokeFailure(AssertionError):
    """A phase's check did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------- #
# Device, cache and timing helpers (shared with bench.py)
# --------------------------------------------------------------------------- #


def compile_cache_dir(environ=os.environ, repo: str = REPO) -> str:
    """JAX's persistent compile cache: ``JAX_COMPILATION_CACHE_DIR`` when it
    is set, else the fixed ``<repo>/.jax_cache`` (a fixed path, because the
    path is part of the cache key)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(repo, ".jax_cache")


def use_compile_cache() -> str:
    """Point this process, and the children it starts, at
    :func:`compile_cache_dir`. Sets nothing when the variable is set."""
    import jax

    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = path
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> dict:
    """The device as JAX reports it; raises unless it is a GPU."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX found platform {dev.platform!r} ({dev.device_kind}); "
            "this program measures and checks the GPU only"
        )
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}


def gpu_name_and_power() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


def warm_ms(fn, iters: int) -> float:
    """Best of three rounds of ``iters`` calls, each round ended by
    ``block_until_ready``: milliseconds per call."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


# --------------------------------------------------------------------------- #
# The flagship and its data
# --------------------------------------------------------------------------- #


def flagship_circuit(side: int, units: int, *, em_ready: bool = False):
    from cirkit_tpu.models import image_data

    return image_data(
        (1, side, side), "quad-graph", input_layer="categorical",
        num_input_units=units, sum_product_layer="tucker", num_sum_units=units,
        em_ready=em_ready,
    )


def build_flagship(sz: Sizes, *, em_ready: bool = False, seed: int = 42):
    """(ctx, compiled circuit): parameters drawn on the default device."""
    from cirkit_tpu.pipeline import PipelineContext

    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=seed)
    return ctx, ctx.compile(flagship_circuit(sz.side, sz.units, em_ready=em_ready))


def pixels(batch: int, side: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (batch, side * side), dtype=np.int32)


def mean_ll_grad(cc, store: dict, x):
    """Gradient of the mean log-likelihood over ``x`` with respect to every
    floating-point entry of ``store``."""
    import jax
    import jax.numpy as jnp

    keys = [k for k, v in store.items() if jnp.issubdtype(v.dtype, jnp.floating)]
    rest = {k: v for k, v in store.items() if k not in keys}

    def mean_ll(params):
        return jnp.mean(cc.evaluate({**rest, **params}, x)[:, 0, 0])

    return jax.jit(jax.grad(mean_ll))({k: store[k] for k in keys})


def reference(sz: Sizes, store: dict, x: np.ndarray, grads: dict | None = None):
    """The flagship in float64, from a child process on the CPU that never
    opens the GPU: ``(per-sample log-likelihood at x, norms)``. ``grads``
    maps a label to a gradient of the mean log-likelihood over ``x`` (as
    :func:`mean_ll_grad` gives it); ``norms`` maps the label to
    ``{entry: [L2 norm of the float64 gradient, L2 norm of the error]}``."""
    grads = grads or {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
    try:
        np.savez(os.path.join(tmp, "store.npz"), **{k: np.asarray(v) for k, v in store.items()})
        np.save(os.path.join(tmp, "x.npy"), x)
        for i, g in enumerate(grads.values()):
            np.savez(os.path.join(tmp, f"grad{i}.npz"), **{k: np.asarray(v) for k, v in g.items()})
        with open(os.path.join(tmp, "sizes.json"), "w") as f:
            json.dump({"sizes": dataclasses.asdict(sz), "grads": len(grads)}, f)
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1"}
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke._reference_child({tmp!r})"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            raise SmokeFailure(f"float64 reference child failed:\n{proc.stderr[-3000:]}")
        with open(os.path.join(tmp, "grad_err.json")) as f:
            errs = json.load(f)
        return np.load(os.path.join(tmp, "ll.npy")), dict(zip(grads, errs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _reference_child(tmp: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cirkit_tpu.pipeline import retrieve_compiler

    with open(os.path.join(tmp, "sizes.json")) as f:
        meta = json.load(f)
    sz = Sizes(**meta["sizes"])
    compiler = retrieve_compiler("jax", semiring="lse-sum", fold=True, optimize=True)
    cc = compiler.compile(flagship_circuit(sz.side, sz.units))
    with np.load(os.path.join(tmp, "store.npz")) as z:
        store = {
            k: jnp.asarray(z[k].astype(np.float64) if np.issubdtype(z[k].dtype, np.floating) else z[k])
            for k in z.files
        }
    x = jnp.asarray(np.load(os.path.join(tmp, "x.npy")))
    ll = jax.jit(cc.evaluate)(store, x)
    np.save(os.path.join(tmp, "ll.npy"), np.asarray(ll, np.float64).reshape(x.shape[0], -1)[:, 0])
    norms = []  # per gradient: entry -> [norm of the float64 gradient, norm of the error]
    if meta["grads"]:
        want = {k: np.asarray(v) for k, v in mean_ll_grad(cc, store, x).items()}
        for i in range(meta["grads"]):
            with np.load(os.path.join(tmp, f"grad{i}.npz")) as got:
                norms.append({
                    k: [float(np.linalg.norm(ref)),
                        float(np.linalg.norm(got[k].astype(np.float64) - ref))]
                    for k, ref in want.items()
                })
    with open(os.path.join(tmp, "grad_err.json"), "w") as f:
        json.dump(norms, f)


# --------------------------------------------------------------------------- #
# Trace and HLO readers
# --------------------------------------------------------------------------- #


def top_device_ops(fn, limit: int = 8) -> list[tuple[str, float, float]]:
    """Run ``fn`` once under the profiler; return ``(op, ms, share)`` of the
    device ops that took the most time. Device planes are ``/device:*``;
    their "XLA Ops" line (or every line, when there is none) is summed."""
    import jax

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        jax.block_until_ready(fn())
        jax.profiler.start_trace(tmp)
        try:
            jax.block_until_ready(fn())
        finally:
            jax.profiler.stop_trace()
        paths = glob.glob(os.path.join(tmp, "plugins", "profile", "*", "*.xplane.pb"))
        if not paths:
            return []
        data = jax.profiler.ProfileData.from_file(paths[0])
        per_op: dict[str, float] = defaultdict(float)
        for plane in data.planes:
            if not plane.name.startswith("/device:"):
                continue
            lines = list(plane.lines)
            ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
            for line in ops:
                for ev in line.events:
                    per_op[ev.name] += ev.duration_ns
        total = sum(per_op.values()) or 1.0
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:limit]
        return [(name, ns / 1e6, ns / total) for name, ns in top]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_HLO_SHAPE = re.compile(r"(\S+) = (f32|f64|bf16|c64|s32)\[([\d,]+)\]\S* (\w[\w-]*)\(")
_BYTES = {"f32": 4, "f64": 8, "bf16": 2, "c64": 8, "s32": 4}


def largest_buffers(hlo_text: str, limit: int = 5) -> list[tuple[str, str, int]]:
    """``(instruction, shape, bytes)`` of the largest arrays an optimized
    HLO module produces (parameters excluded)."""
    seen: dict[tuple[str, str], tuple[str, int]] = {}
    for name, dt, dims, opcode in _HLO_SHAPE.findall(hlo_text):
        if opcode == "parameter":
            continue
        n = _BYTES[dt] * int(np.prod([int(d) for d in dims.split(",")]))
        shape = f"{dt}[{dims}]"
        key = (opcode, shape)
        if key not in seen or seen[key][1] < n:
            seen[key] = (name, n)
    rows = [(f"{op} {name}", shape, n) for (op, shape), (name, n) in seen.items()]
    return sorted(rows, key=lambda r: -r[2])[:limit]


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #


def phase_device(sz: Sizes, log, *, card: str) -> dict:
    import jax

    dev = require_gpu()
    log(f"device: {dev['platform']} x{dev['count']} {dev['kind']}")
    log(f"card (nvidia-smi name, power.limit): {card}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {os.environ.get('JAX_COMPILATION_CACHE_DIR')}")
    return dev


def phase_forward(sz: Sizes, log, *, card: str = "", control: str | None = BF16_CONTROL) -> dict:
    """The forward checks. ``control`` names a lower dot precision whose error
    is printed beside the limit; None skips it (the CPU's float64 dots take
    no bf16 algorithm)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import entry

    fn, args = entry(image_hw=sz.side, num_units=sz.units, batch=sz.batch)
    cp_out = np.asarray(jax.jit(fn)(*args))
    del fn, args
    check(cp_out.shape[0] == sz.batch and np.isfinite(cp_out).all(), "CP forward not finite")
    log(f"forward: CP K={sz.units} finite, shape {cp_out.shape}")

    ctx, cc = build_flagship(sz)
    store = cc.restrict_store(ctx.parameters)
    n_params = sum(int(np.prod(v.shape)) for v in store.values())
    x_np = pixels(sz.batch, sz.side)
    x = jnp.asarray(x_np)
    x_ref = x_np[: sz.ref_batch]
    t0 = time.perf_counter()
    grad = mean_ll_grad(cc, store, jnp.asarray(x_ref))
    grad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref, grad_err = reference(sz, store, x_ref, {"program default": grad})
    del grad
    log(f"forward: Tucker K={sz.units}, {n_params} parameters; float64 CPU reference "
        f"on {sz.ref_batch} samples in {time.perf_counter() - t0:.1f} s "
        f"(mean LL {ref.mean():.4f})")
    norms = np.asarray(list(grad_err["program default"].values()))  # [ref, err] per entry
    worst = int(np.argmax(norms[:, 1] / np.maximum(norms[:, 0], np.finfo(np.float64).tiny)))
    res = {
        "params": n_params,
        "grad_rel_err": float(np.linalg.norm(norms[:, 1]) / np.linalg.norm(norms[:, 0])),
    }
    log(f"forward gradient of the mean LL at the program default: relative L2 error "
        f"{res['grad_rel_err']:.3e} (limit {GRAD_REL_TOL:g}); worst store entry "
        f"{norms[worst, 1] / norms[worst, 0]:.3e} relative, its float64 gradient's norm "
        f"{norms[worst, 0]:.3e} of {np.linalg.norm(norms[:, 0]):.3e} in all; "
        f"first call {grad_s:.1f} s")

    for prec in ("default", "high", "highest", *([control] if control else []), None):
        label = "program default" if prec is None else "bf16 control" if prec == control else prec
        with jax.default_matmul_precision(prec) if prec else contextlib.nullcontext():
            fwd = jax.jit(lambda st, xx: cc.evaluate(st, xx))
            t0 = time.perf_counter()
            out = np.asarray(jax.block_until_ready(fwd(store, x)))
            compile_s = time.perf_counter() - t0
            ms = warm_ms(lambda: fwd(store, x), sz.iters)
        check(out.shape == (sz.batch, 1, 1), f"forward shape {out.shape}")
        check(np.isfinite(out).all(), f"non-finite forward at {label}")
        ll = out[: sz.ref_batch, 0, 0].astype(np.float64)
        err = float(np.max(np.abs(ll - ref) / np.abs(ref)))
        res[label] = {"max_rel_err": err, "batch_ms": ms, "compile_s": compile_s}
        verdict = "within" if err <= LL_REL_TOL else "outside"
        log(f"forward precision {label}: max rel err of per-sample LL {err:.3e} ({verdict} "
            f"the limit {LL_REL_TOL:g}); {ms:.3f} ms per batch of {sz.batch} "
            f"(first call {compile_s:.1f} s); {card}")
    check(res["program default"]["max_rel_err"] <= LL_REL_TOL,
          f"program-default precision error exceeds {LL_REL_TOL}")
    check(res["grad_rel_err"] <= GRAD_REL_TOL,
          f"program-default gradient error exceeds {GRAD_REL_TOL}")

    compiled = jax.jit(lambda st, xx: cc.evaluate(st, xx)).lower(store, x).compile()
    ma = compiled.memory_analysis()
    if ma is not None:
        log("forward memory_analysis (bytes): "
            f"arguments {ma.argument_size_in_bytes}, outputs {ma.output_size_in_bytes}, "
            f"temp {ma.temp_size_in_bytes}, code {ma.generated_code_size_in_bytes}")
        res["temp_bytes"] = int(ma.temp_size_in_bytes)
    for op, shape, n in largest_buffers(compiled.as_text()):
        log(f"forward largest buffer: {shape} ({n / 1e9:.3f} GB) from {op}")
    fwd = jax.jit(lambda st, xx: cc.evaluate(st, xx))
    top = top_device_ops(lambda: fwd(store, x))
    if jax.devices()[0].platform == "gpu":
        check(bool(top), "the trace shows no device op")
    for name, ms, share in top:
        log(f"forward top device op: {ms:.3f} ms ({share:.1%}) {name[:110]}")
    res["top_ops"] = top
    return res


def phase_train(sz: Sizes, log) -> dict:
    import optax

    from cirkit_tpu.parallel import default_mesh, fit, fit_em
    from cirkit_tpu.parallel.optimizers import adam_lowmem

    ctx, cc = build_flagship(sz)
    batch = pixels(sz.batch, sz.side, seed=1)
    res = {}
    for name, opt in (("adam", optax.adam(1e-2)), ("adam_lowmem", adam_lowmem(1e-2))):
        stamps = [time.perf_counter()]
        # one batch, no shuffling: every step sees the same data
        _, losses = fit(
            cc, batch, store=ctx.parameters, num_epochs=sz.train_steps, batch_size=sz.batch,
            optimizer=opt, mesh=default_mesh(1), shuffle=False,
            callback=lambda *_: stamps.append(time.perf_counter()),
        )
        check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
        steps = np.diff(stamps)
        warm = float(np.median(steps[1:]) * 1e3) if len(steps) > 1 else float("nan")
        res[name] = {"losses": losses, "step_ms": warm}
        log(f"train {name}: NLL {' -> '.join(f'{v:.4f}' for v in losses)}; first step "
            f"{steps[0]:.1f} s, then median {warm:.3f} ms per step (host clock, "
            "each step synced by its loss)")
    del ctx, cc

    ctx, cc = build_flagship(sz, em_ready=True)
    data = pixels(2 * sz.batch, sz.side, seed=2)
    _, em_losses = fit_em(cc, data, store=ctx.parameters, num_epochs=2, batch_size=sz.batch)
    check(all(np.isfinite(em_losses)), f"EM: non-finite NLL {em_losses}")
    check(em_losses[1] <= em_losses[0], f"EM: NLL rose {em_losses}")
    res["em"] = em_losses
    log(f"train EM: NLL per epoch {em_losses[0]:.4f} -> {em_losses[1]:.4f}")
    return res


def phase_queries(sz: Sizes, log) -> dict:
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.queries import IntegrateQuery, MAPQuery, SamplingQuery

    ctx, cc = build_flagship(sz)
    store = cc.restrict_store(ctx.parameters)
    x_np = pixels(sz.batch, sz.side, seed=3)
    x = jnp.asarray(x_np)
    mask = np.random.default_rng(4).random(x_np.shape) < 0.5
    fwd = jax.jit(lambda st, xx: cc.evaluate(st, xx))
    ll = np.asarray(fwd(store, x))[:, 0, 0]

    iq = IntegrateQuery(cc)
    marg = np.asarray(iq(x, integrate_vars=jnp.zeros(x.shape, bool), store=store))[:, 0, 0]
    check(np.allclose(marg, ll, rtol=1e-5, atol=0), "integrate with an empty mask != forward")

    mq = MAPQuery(cc)
    asg, val = mq(x, evidence_mask=jnp.asarray(mask), store=store)
    asg, val = np.asarray(asg), np.asarray(val).reshape(-1)
    check(np.isfinite(val).all(), "MAP value not finite")
    check(np.array_equal(asg[mask].astype(np.int64), x_np[mask]), "MAP changed the evidence")
    ll_asg = np.asarray(fwd(store, jnp.asarray(asg.astype(np.int32))))[:, 0, 0]
    # the best parse's weight lower-bounds the completion's likelihood ...
    check((val <= ll_asg + 1e-5 * np.abs(ll_asg)).all(), "MAP value above the completion's LL")
    # ... and, the completion being the joint argmax, is its best parse
    _, val_full = mq(jnp.asarray(asg.astype(np.int32)), evidence_mask=jnp.ones(x.shape, bool),
                     store=store)
    check(np.allclose(np.asarray(val_full).reshape(-1), val, rtol=1e-5, atol=0),
          "MAP value != best-parse value of the completed assignment")
    log(f"queries: integrate(empty mask) == forward; MAP keeps evidence, value "
        f"{val.mean():.4f} <= completion LL {ll_asg.mean():.4f} (mean)")

    samples, le = SamplingQuery(cc).conditional(
        x, evidence_mask=jnp.asarray(mask), key=jax.random.PRNGKey(0), store=store
    )
    samples, le = np.asarray(samples), np.asarray(le).reshape(-1)
    check(np.isfinite(le).all(), "sampling log-evidence not finite")
    check(np.array_equal(samples[mask].astype(np.int64), x_np[mask]), "sampling changed the evidence")
    ev = np.asarray(iq(x, integrate_vars=jnp.asarray(~mask), store=store))[:, 0, 0]
    check(np.allclose(le, ev, rtol=1e-5, atol=0), "sampling log-evidence != integrate")
    log("queries: conditional sampling keeps evidence; log-evidence == integrate")
    return {"map_value": float(val.mean()), "log_evidence": float(le.mean())}


def phase_sos(sz: Sizes, log) -> dict:
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.models import image_data
    from cirkit_tpu.models.utils import Parameterization
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, sz.sos_side, sz.sos_side), "quad-tree-2", input_layer="categorical",
        num_input_units=sz.sos_units, sum_product_layer="cp", num_sum_units=sz.sos_units,
        sum_weight_param=Parameterization(activation="none", initialization="normal"),
    )
    x = jnp.asarray(pixels(sz.batch, sz.sos_side, seed=5))
    outs = {}
    store = None
    for semiring in ("signed-lse-sum", "complex-lse-sum"):
        ctx = PipelineContext(semiring=semiring, fold=True, optimize=True)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        if store is None:
            store = sq.restrict_store(ctx.parameters)
        check(set(sq.restrict_store(ctx.parameters)) == set(store), "slot names differ")
        outs[semiring] = jax.jit(lambda st, xx, sq=sq: sq.evaluate(st, xx))(store, x)
    logmag, sign = (np.asarray(a).reshape(-1) for a in outs["signed-lse-sum"])
    z = np.asarray(outs["complex-lse-sum"]).reshape(-1)
    check(np.isfinite(logmag).all() and np.isfinite(z).all(), "squared circuit not finite")
    # Both evaluate the same real circuit; the sums cancel, so f32 rounding
    # reaches ~2e-4 of the log-magnitude on the worst samples (PERF.md,
    # "Precision"). A flipped sign would show as a phase near pi.
    rel = np.abs(z.real - logmag) / np.maximum(1.0, np.abs(logmag))
    phase = np.angle(np.exp(1j * z.imag)) - np.where(sign < 0, np.pi, 0.0)
    phase = np.abs(np.angle(np.exp(1j * phase)))
    err, ph = float(rel.max()), float(phase.max())
    check(err <= 1e-3 and ph <= 0.1, f"signed vs complex: rel {err:.3e}, phase {ph:.3e}")
    log(f"sos: {sz.sos_side}x{sz.sos_side} K={sz.sos_units} signed == complex: log-magnitude "
        f"max rel diff {err:.3e} (median {float(np.median(rel)):.3e}), max phase diff "
        f"{ph:.3e} rad; signs {int((sign > 0).sum())} positive of {sign.size}")
    return {"rel_err": err, "phase": ph}


def phase_warmstart(sz: Sizes, log) -> dict:
    import jax
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax.warmstart import load_bundle, save_bundle
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    sc = image_data(
        (1, sz.warm_side, sz.warm_side), "quad-graph", input_layer="categorical",
        num_input_units=sz.warm_units, sum_product_layer="tucker", num_sum_units=sz.warm_units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    store = cc.restrict_store(ctx.parameters)
    x = jnp.asarray(pixels(sz.batch, sz.warm_side, seed=6))
    fwd = jax.jit(lambda st, xx: cc.evaluate(st, xx))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bundle_")
    try:
        save_bundle(os.path.join(tmp, "b"), cc, store=dict(ctx.parameters), batch=sz.batch)
        bundle = load_bundle(os.path.join(tmp, "b"))
        same = np.array_equal(np.asarray(bundle.evaluate(store, x)), np.asarray(fwd(store, x)))
        check(same, "bundle forward != compiled forward")
        drawn = bundle.init(0)
        out = np.asarray(bundle.evaluate(drawn, x))
        check(np.isfinite(out).all(), "bundle forward on its own init not finite")
        check(np.array_equal(out, np.asarray(fwd(cc.restrict_store(drawn), x))),
              "bundle forward on its init != compiled forward")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("warmstart: save_bundle -> load_bundle forward == compiled forward")
    return {}


def phase_four(sz: Sizes, log, n: int = 4) -> dict:
    """Multi-device training and queries, each against one device."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from cirkit_tpu.backend.jax.queries import MAPQuery, SamplingQuery
    from cirkit_tpu.parallel import default_mesh, replicate_store, shard_batch
    from cirkit_tpu.parallel.tensor import shard_store_tp, tp_train_step
    from cirkit_tpu.parallel.training import (
        data_parallel_step,
        shard_opt_state_zero1,
        split_trainable,
    )

    from jax.sharding import NamedSharding, PartitionSpec

    devices = jax.devices()
    check(len(devices) >= n, f"need {n} devices, found {len(devices)}")

    def placed(state, mesh):
        # the fresh state's step count lives on one device; the steps
        # return it replicated (as fit places it)
        return jax.tree_util.tree_map(
            lambda a: a if isinstance(a.sharding, NamedSharding)
            else jax.device_put(a, NamedSharding(mesh, PartitionSpec())),
            state,
        )
    ctx, cc = build_flagship(sz)
    trainable, frozen = split_trainable(cc, ctx.parameters)
    x_np = pixels(sz.batch, sz.side, seed=7)
    opt = optax.adam(1e-2)

    def two(step, tr, fr, st, xb):
        tr, st, l1 = step(tr, fr, st, xb)
        _, _, l2 = step(tr, fr, st, xb)
        return np.asarray([float(l1), float(l2)])

    one = {k: jnp.array(v) for k, v in trainable.items()}
    want = two(data_parallel_step(cc, opt), one, frozen, opt.init(one), jnp.asarray(x_np))
    mesh = default_mesh(n)
    runs = {}
    tr, fr = replicate_store(trainable, mesh), replicate_store(frozen, mesh)
    runs["DP"] = two(data_parallel_step(cc, opt, mesh=mesh), tr, fr,
                     placed(opt.init(tr), mesh), shard_batch(x_np, mesh))
    tr = replicate_store(trainable, mesh)
    runs["ZeRO-1"] = two(data_parallel_step(cc, opt, mesh=mesh, zero1=True), tr, fr,
                         shard_opt_state_zero1(opt.init(tr), mesh), shard_batch(x_np, mesh))
    mesh2 = Mesh(np.asarray(devices[:n]).reshape(n // 2, 2), ("data", "model"))
    tr2, _ = shard_store_tp(cc, trainable, mesh2)
    fr2, _ = shard_store_tp(cc, frozen, mesh2)
    runs["TPxDP"] = two(tp_train_step(cc, opt, mesh2), tr2, fr2, placed(opt.init(tr2), mesh2),
                        jnp.asarray(x_np))
    for name, got in runs.items():
        check(np.allclose(got, want, rtol=1e-4, atol=0),
              f"{name} losses {got} != one device {want}")
        log(f"four {name}: losses {got[0]:.6f}, {got[1]:.6f} == one device "
            f"{want[0]:.6f}, {want[1]:.6f}")

    store = cc.restrict_store(ctx.parameters)
    mask = np.random.default_rng(8).random(x_np.shape) < 0.5
    mesh_q = Mesh(np.asarray(devices[:n]).reshape(2, n // 2), ("model", "data"))
    tp_store, _ = shard_store_tp(cc, store, mesh_q)
    a1, v1 = MAPQuery(cc)(x_np, evidence_mask=mask, store=store)
    a2, v2 = MAPQuery(cc, mesh=mesh_q)(x_np, evidence_mask=mask, store=tp_store)
    same_a = float(np.mean(np.asarray(a1) == np.asarray(a2)))
    check(same_a >= 0.999, f"TP MAP assignments agree on {same_a:.4%}")
    check(np.allclose(np.asarray(v2), np.asarray(v1), rtol=1e-5, atol=0), "TP MAP values differ")
    key = jax.random.PRNGKey(9)
    s1, e1 = SamplingQuery(cc).conditional(x_np, evidence_mask=mask, key=key, store=store)
    s2, e2 = SamplingQuery(cc, mesh=mesh_q).conditional(
        x_np, evidence_mask=mask, key=key, store=tp_store
    )
    same_s = float(np.mean(np.asarray(s1) == np.asarray(s2)))
    check(np.array_equal(np.asarray(s2)[mask].astype(np.int64), x_np[mask]), "TP sampling evidence")
    check(same_s >= 0.99, f"TP samples agree on {same_s:.4%}")
    check(np.allclose(np.asarray(e2), np.asarray(e1), rtol=1e-5, atol=0), "TP log-evidence differs")
    log(f"four TP queries: MAP assignments agree {same_a:.4%}, samples {same_s:.4%}, "
        "values == one device")
    return {**{k: v.tolist() for k, v in runs.items()}, "one": want.tolist()}


PHASES = (
    ("forward", phase_forward),
    ("train", phase_train),
    ("queries", phase_queries),
    ("sos", phase_sos),
    ("warmstart", phase_warmstart),
)


def main(argv: list[str]) -> int:
    four = "--four" in argv
    unknown = [a for a in argv if a != "--four"]
    if unknown:
        print(f"unknown arguments {unknown}; usage: chip_smoke.py [--four]", file=sys.stderr)
        return 2
    import cirkit_tpu  # noqa: F401  (fails outside a checkout of the repo)

    use_compile_cache()

    def log(msg: str) -> None:
        print(msg, flush=True)

    sz = Sizes()
    card = gpu_name_and_power() if shutil.which("nvidia-smi") else ""
    try:
        dev = phase_device(sz, log, card=card)
    except SmokeFailure as exc:
        print(f"FAILED device: {exc}", file=sys.stderr)
        return 1
    phases = (("four", phase_four),) if four else PHASES
    failed = []
    for name, phase in phases:
        t0 = time.perf_counter()
        try:
            phase(sz, log, card=card) if name == "forward" else phase(sz, log)
        except Exception:  # report every phase, then fail the run
            failed.append(name)
            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
