"""The transparent warm-compile cache (backend/jax/warmcache.py).

The warm cache serializes compiled executables to disk keyed by (circuit
fingerprint, arg shapes, device/env fingerprint) so a SECOND process
deserializes instead of tracing and compiling — automatically, with no
bundle-management code (the explicit bundle API in warmstart.py remains
for zero-Python-rebuild startup).

The cache is off unless CIRKIT_TPU_CACHE names its directory.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from cirkit_tpu.backend.jax import warmcache as W
from cirkit_tpu.models import image_data
from cirkit_tpu.pipeline import PipelineContext


def _compile(units=8):
    sc = image_data(
        (1, 2, 2), region_graph="quad-tree-2", input_layer="categorical",
        num_input_units=units, sum_product_layer="cp", num_sum_units=units,
    )
    ctx = PipelineContext(backend="jax", semiring="lse-sum")
    return ctx.compile(sc), ctx


def test_fingerprint_stable_across_compiles():
    cc1, _ = _compile()
    cc2, _ = _compile()
    assert W.circuit_fingerprint(cc1) == W.circuit_fingerprint(cc2)


def test_fingerprint_separates_structures():
    cc1, _ = _compile(units=8)
    cc2, _ = _compile(units=4)
    assert W.circuit_fingerprint(cc1) != W.circuit_fingerprint(cc2)


def test_cache_disabled_on_cpu_by_default(monkeypatch):
    monkeypatch.delenv("CIRKIT_TPU_CACHE", raising=False)
    assert W.cache_dir() is None  # test suite runs on the CPU backend


@pytest.mark.parametrize("backend", ["gpu", "rocm"])
def test_cache_off_without_dir_on_any_backend(monkeypatch, backend):
    monkeypatch.delenv("CIRKIT_TPU_CACHE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert W.cache_dir() is None


def test_env_fingerprint_keys_the_matmul_precision():
    plain = W._env_fingerprint()
    with jax.default_matmul_precision("highest"):
        assert W._env_fingerprint() != plain


@pytest.mark.parametrize("value", ["dir", ""])
def test_cache_dir_is_the_env_dir(monkeypatch, tmp_path, value):
    """``CIRKIT_TPU_CACHE`` alone turns the cache on; empty leaves it off."""
    path = str(tmp_path) if value else ""
    monkeypatch.setenv("CIRKIT_TPU_CACHE", path)
    assert W.cache_dir() == (tmp_path if value else None)


def test_cached_jit_round_trip_and_corruption_fallback(monkeypatch, tmp_path):
    monkeypatch.setenv("CIRKIT_TPU_CACHE", str(tmp_path))
    before = dict(W.stats)

    fn = W.CachedJit(lambda a: a * 2.0 + 1.0, name="t", key_parts=("k",))
    x = np.arange(8, dtype=np.float32)
    out1 = np.asarray(fn(x))
    assert W.stats["misses"] == before["misses"] + 1

    # a FRESH CachedJit (same key parts) must hit the disk entry
    fn2 = W.CachedJit(lambda a: a * 2.0 + 1.0, name="t", key_parts=("k",))
    out2 = np.asarray(fn2(x))
    assert W.stats["hits"] == before["hits"] + 1
    np.testing.assert_array_equal(out1, out2)

    # corrupt every payload: the next fresh instance must fall back to a
    # plain compile (a miss), not crash
    for p in tmp_path.rglob("*.jaxexec"):
        p.write_bytes(b"garbage")
    fn3 = W.CachedJit(lambda a: a * 2.0 + 1.0, name="t", key_parts=("k",))
    out3 = np.asarray(fn3(x))
    np.testing.assert_array_equal(out1, out3)
    assert W.stats["misses"] == before["misses"] + 2


def test_cached_jit_kwargs_round_trip(monkeypatch, tmp_path):
    """Keyword arguments ride the cache too (the routing programs pass
    key= by name): the signature hash covers the kwargs tree and the
    serialized in_tree matches the call convention."""
    monkeypatch.setenv("CIRKIT_TPU_CACHE", str(tmp_path))
    before = dict(W.stats)
    x = np.arange(8, dtype=np.float32)
    k = np.float32(3.0)

    fn = W.CachedJit(lambda a, scale=None: a * scale, name="kw", key_parts=())
    out1 = np.asarray(fn(x, scale=k))
    assert W.stats["misses"] == before["misses"] + 1
    fn2 = W.CachedJit(lambda a, scale=None: a * scale, name="kw", key_parts=())
    out2 = np.asarray(fn2(x, scale=k))
    assert W.stats["hits"] == before["hits"] + 1
    np.testing.assert_array_equal(out1, out2)


def test_sharded_args_skip_cache(monkeypatch, tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    monkeypatch.setenv("CIRKIT_TPU_CACHE", str(tmp_path))
    mesh = Mesh(np.array(jax.devices()), ("data",))
    x = jax.device_put(
        np.arange(16, dtype=np.float32), NamedSharding(mesh, P("data"))
    )
    fn = W.CachedJit(lambda a: a + 1.0, name="sharded", key_parts=())
    np.testing.assert_array_equal(np.asarray(fn(x)), np.arange(16) + 1.0)
    assert not list(tmp_path.rglob("*.jaxexec"))  # nothing cached


_PROBE = """
import os, sys, json
os.environ["CIRKIT_TPU_CACHE"] = sys.argv[1]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from cirkit_tpu.models import image_data
from cirkit_tpu.pipeline import PipelineContext
from cirkit_tpu.parallel import fit
from cirkit_tpu.backend.jax import warmcache

sc = image_data((1, 2, 2), region_graph="quad-tree-2", input_layer="categorical",
                num_input_units=8, sum_product_layer="cp", num_sum_units=8)
ctx = PipelineContext(backend="jax", semiring="lse-sum")
cc = ctx.compile(sc)
x = np.random.default_rng(0).integers(0, 256, (16, 4)).astype(np.int32)
out = cc(x)
st, losses = fit(cc, x, num_epochs=1, batch_size=16, key=jax.random.PRNGKey(0))

# query programs consult the cache too (integrate / routing / expectation)
from cirkit_tpu.backend.jax import ExpectationQuery, IntegrateQuery, MAPQuery
mk = np.zeros((16, 4), bool); mk[:, :2] = True
marg = IntegrateQuery(cc)(x, integrate_vars=~mk)
a, v = MAPQuery(cc)(x, evidence_mask=mk, store=st)
soft = ExpectationQuery(cc)(x, evidence_mask=mk, store=st)
print(json.dumps({"stats": warmcache.stats, "out0": float(np.asarray(out)[0, 0, 0]),
                  "loss0": float(losses[0]), "marg0": float(np.asarray(marg)[0, 0, 0]),
                  "map0": float(np.asarray(v)[0]), "soft0": float(np.asarray(soft)[0, 2])}))
"""


@pytest.mark.slow
def test_second_process_hits_cache(tmp_path):
    """End to end across real processes: evaluate + fit-step compiles cache
    in process 1 and deserialize in process 2 with identical numbers."""
    env = {**os.environ}
    env.pop("XLA_FLAGS", None)  # single-device: cached executables pin devices
    results = []
    for _ in range(2):
        out = subprocess.run(
            [sys.executable, "-c", _PROBE, str(tmp_path)],
            capture_output=True, text=True, timeout=300, env=env,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
    first, second = results
    assert first["stats"]["misses"] >= 5 and first["stats"]["hits"] == 0
    assert second["stats"]["hits"] >= 5 and second["stats"]["misses"] == 0
    for field in ("out0", "loss0", "marg0", "map0", "soft0"):
        assert second[field] == first[field], field
