"""Compare compilation options (the reference's
``compilation-options.ipynb``): unfolded vs folded vs folded+optimized
evaluation of the MNIST QuadGraph Tucker K=64 circuit.

Run: python examples/compilation_options.py   (small sizes by default;
set UNITS=64 SIDE=28 for the full reference configuration)
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.models import image_data
from cirkit_tpu.pipeline import PipelineContext


def bench(fold: bool, optimize: bool, units: int, side: int, batch: int = 128):
    sc = image_data(
        (1, side, side),
        "quad-graph",
        input_layer="categorical",
        num_input_units=units,
        sum_product_layer="tucker",
        num_sum_units=units,
    )
    t0 = time.time()
    ctx = PipelineContext(semiring="lse-sum", fold=fold, optimize=optimize)
    cc = ctx.compile(sc)
    build_s = time.time() - t0
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, size=(batch, side * side))
    )
    store = {k: v for k, v in ctx.parameters.items() if k in cc.used_slots}
    fwd = jax.jit(lambda st, xx: cc.evaluate(st, xx))
    out = fwd(store, x)
    float(jnp.sum(out))  # compile + sync
    t0 = time.time()
    for _ in range(10):
        out = fwd(store, x)
    float(jnp.sum(out))
    ms = (time.time() - t0) / 10 * 1e3
    tag = f"fold={fold} optimize={optimize}"
    print(f"{tag:28s} compile {build_s:5.1f}s   forward {ms:8.2f} ms/batch")
    return ms


def main() -> None:
    units = int(os.environ.get("UNITS", "16"))
    side = int(os.environ.get("SIDE", "12"))
    print(f"QuadGraph Tucker K={units} over {side}x{side} images")
    t_unfolded = bench(False, False, units, side)
    t_folded = bench(True, False, units, side)
    t_optimized = bench(True, True, units, side)
    print(f"folding speed-up:           {t_unfolded / t_folded:6.1f}x")
    print(f"fusion speed-up:            {t_folded / t_optimized:6.1f}x more")


if __name__ == "__main__":
    main()
