"""``chip_smoke.py``: its phases at tiny sizes on the CPU, the multi-device
phase on four virtual CPU devices, its device and compile-cache rules, and
its trace and HLO readers. On the GPU the same functions run at full size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as S

TINY = S.Sizes(
    side=4, units=4, batch=8, ref_batch=4, sos_side=4, sos_units=4,
    train_steps=3, warm_side=4, warm_units=4, iters=1,
)


def _log(lines):
    return lambda msg: lines.append(msg)


def test_forward_phase_tiny():
    lines = []
    res = S.phase_forward(TINY, _log(lines), card="cpu", control=None)
    # the CPU computes f32 dots exactly at every precision setting; the
    # float64 run here agrees to rounding with the float64 reference
    for label in ("default", "high", "highest", "program default"):
        assert res[label]["max_rel_err"] < 1e-9
    assert res["grad_rel_err"] < 1e-9
    assert res["params"] > 0
    assert any("largest buffer" in ln for ln in lines)


def test_train_phase_tiny():
    res = S.phase_train(TINY, lambda _: None)
    for name in ("adam", "adam_lowmem"):
        assert len(res[name]["losses"]) == TINY.train_steps
        assert res[name]["losses"][-1] < res[name]["losses"][0]
    assert res["em"][1] <= res["em"][0]


def test_queries_phase_tiny():
    res = S.phase_queries(TINY, lambda _: None)
    assert np.isfinite(res["map_value"]) and np.isfinite(res["log_evidence"])


def test_sos_phase_tiny():
    res = S.phase_sos(TINY, lambda _: None)
    assert res["rel_err"] <= 1e-4


def test_warmstart_phase_tiny():
    lines = []
    S.phase_warmstart(TINY, _log(lines))
    assert lines and "load_bundle" in lines[0]


def test_four_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4  # conftest forces 8 virtual CPU devices
    res = S.phase_four(TINY, lambda _: None)
    for name in ("DP", "ZeRO-1", "TPxDP"):
        np.testing.assert_allclose(res[name], res["one"], rtol=1e-9)


def test_device_check_refuses_the_cpu():
    with pytest.raises(S.SmokeFailure, match="no GPU"):
        S.require_gpu()


def test_main_exits_nonzero_without_a_gpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert S.main([]) == 1
    assert S.main(["--four"]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_main_rejects_unknown_arguments(capsys):
    assert S.main(["--eight"]) == 2


@pytest.mark.parametrize(
    "environ,want",
    [({"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}, "/somewhere/cache"), ({}, "/r/.jax_cache")],
    ids=["env-set", "env-unset"],
)
def test_compile_cache_dir_rule(environ, want):
    assert S.compile_cache_dir(environ, "/r") == want


def test_use_compile_cache_leaves_a_set_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert S.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_largest_buffers_reads_optimized_hlo():
    hlo = "\n".join([
        "  %p0 = f32[1024,1024]{1,0} parameter(0)",
        "  %fusion.1 = f32[8,64,4096]{2,1,0} fusion(%p0), kind=kLoop",
        "  %dot.2 = f32[8,64]{1,0} dot(%fusion.1, %p0)",
        "  %c = bf16[2,3]{1,0} convert(%dot.2)",
    ])
    rows = S.largest_buffers(hlo, limit=2)
    assert rows[0] == ("fusion %fusion.1", "f32[8,64,4096]", 8 * 64 * 4096 * 4)
    assert rows[1][1] == "f32[8,64]"
    assert all("parameter" not in r[0] for r in S.largest_buffers(hlo))


def test_top_device_ops_runs_under_the_profiler():
    f = jax.jit(lambda a: jnp.tanh(a @ a))
    x = jnp.ones((64, 64), jnp.float32)
    rows = S.top_device_ops(lambda: f(x))
    # the CPU backend has no /device: plane; a GPU trace lists its ops
    for name, ms, share in rows:
        assert isinstance(name, str) and ms >= 0 and 0 <= share <= 1

