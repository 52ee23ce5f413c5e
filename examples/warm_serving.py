"""Warm-start serving: save a circuit's compiled executables once, then
reach the first batch in a fresh process with zero tracing and zero XLA
compiles.

Cold start pays symbolic build + plan compilation + the init and forward
XLA compiles on EVERY process; the reference pays its analogue (~5.4-5.7 s
symbolic+torch compile, ``notebooks/compilation-options.ipynb``) the same
way. An AOT bundle (``save_bundle``/``load_bundle``) deletes all of it.
Each phase below runs in a process of its own, one after the other, and
this parent process never opens the device: the cold process builds,
compiles and saves the bundle; the warm process loads it and runs a batch
— on a real deployment that process is your serving worker.

Run: python examples/warm_serving.py   (small sizes by default; set
UNITS=64 SIDE=28 for the flagship configuration)
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _sizes() -> tuple[int, int, int]:
    return (
        int(os.environ.get("UNITS", "8")),
        int(os.environ.get("SIDE", "8")),
        int(os.environ.get("BATCH", "32")),
    )


def _pixels(batch: int, side: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (batch, side * side)).astype(np.int32)


def cold(bundle: str) -> None:
    """Build, compile, run the first batch and persist the bundle."""
    import jax.numpy as jnp

    from cirkit_tpu.backend.jax import save_bundle
    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext

    units, side, batch = _sizes()
    t0 = time.time()
    sc = image_data(
        (1, side, side), "quad-graph", input_layer="categorical",
        num_input_units=units, sum_product_layer="tucker", num_sum_units=units,
    )
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    cc = ctx.compile(sc)
    out = np.asarray(cc.evaluate(cc.restrict_store(ctx.parameters), jnp.asarray(_pixels(batch, side))))
    print(f"cold build+compile+first batch: {time.time() - t0:.1f} s; mean LL {out.mean():.2f}")
    t0 = time.time()
    save_bundle(bundle, cc, store=dict(ctx.parameters), batch=batch, with_integrate=True)
    print(f"bundle saved in {time.time() - t0:.1f} s -> {bundle}")


def warm(bundle: str) -> None:
    """Load the bundle and serve a batch: no tracing, no compiles."""
    t0 = time.time()
    import jax

    from cirkit_tpu.backend.jax import load_bundle

    _, side, batch = _sizes()
    b = load_bundle(bundle)
    store = b.init(0)
    out = np.asarray(b.evaluate(store, jax.device_put(_pixels(batch, side))))
    print(f"warm load+init+first batch: {time.time() - t0:.2f} s; mean LL {out.mean():.2f}")


def _run(phase: str, bundle: str) -> None:
    env = dict(os.environ)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (here, env.get("PYTHONPATH")) if p)
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), phase, bundle],
        env=env, text=True, capture_output=True, timeout=600,
    )
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        sys.stderr.write(r.stderr)
        raise SystemExit(f"{phase} process failed")


def main() -> None:
    bundle = os.path.join(tempfile.mkdtemp(prefix="warm_serving_"), "bundle")
    _run("cold", bundle)
    _run("warm", bundle)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("cold", "warm"):
        {"cold": cold, "warm": warm}[sys.argv[1]](sys.argv[2])
    else:
        main()
