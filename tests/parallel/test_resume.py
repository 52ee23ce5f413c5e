"""Trainer checkpoint/resume: a run killed mid-way resumes from its last
checkpoint and reproduces the uninterrupted run (SURVEY §5 checkpoint/
resume; the reference covers only cold store round-trips, ref
``tests/backend/torch/test_serialization.py:17-32`` — it has no trainers).

All three trainers are exercised: ``fit`` (step-granular), ``fit_em``
(epoch-granular), and ``grow_prune_loop`` (stage-granular, via
``save_circuit``/``save_store`` artifacts and an atomic LATEST marker).
"""

import numpy as np
import optax
import pytest

from cirkit_tpu.models import image_data
from cirkit_tpu.parallel import evaluate_ll, fit, fit_em
from cirkit_tpu.pipeline import PipelineContext


def _compile(em_ready=False, seed=11):
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=seed)
    sc = image_data(
        (1, 4, 4), "quad-tree-4", input_layer="categorical",
        num_input_units=4, sum_product_layer="cp", num_sum_units=4,
        em_ready=em_ready,
    )
    return sc, ctx, ctx.compile(sc)


def _data(n=96, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 16), dtype=np.int64)


class _Killed(RuntimeError):
    pass


def test_fit_resume_reproduces_uninterrupted_run(tmp_path):
    data = _data()
    ck = tmp_path / "fit_ck"

    _, ctx, cc = _compile()
    full_store, full_losses = fit(
        cc, data, store=dict(ctx.parameters), num_epochs=2, batch_size=32,
        optimizer=optax.adam(0.05),
    )

    # same run, killed at step 4 (checkpoints land at steps 3 then... kill)
    _, ctx2, cc2 = _compile()

    def killer(epoch, step, loss):
        if step == 4:
            raise _Killed

    with pytest.raises(_Killed):
        fit(
            cc2, data, store=dict(ctx2.parameters), num_epochs=2, batch_size=32,
            optimizer=optax.adam(0.05), callback=killer,
            checkpoint_every=3, checkpoint_path=str(ck),
        )
    assert (tmp_path / "fit_ck.npz").exists()

    # a fresh process would rebuild the circuit and resume
    _, ctx3, cc3 = _compile()
    store, losses = fit(
        cc3, data, store=dict(ctx3.parameters), num_epochs=2, batch_size=32,
        optimizer=optax.adam(0.05),
        checkpoint_every=3, checkpoint_path=str(ck), resume=True,
    )
    assert len(losses) == len(full_losses)
    np.testing.assert_allclose(losses, full_losses, rtol=1e-8)
    for k in full_store:
        np.testing.assert_allclose(
            np.asarray(store[k]), np.asarray(full_store[k]), rtol=1e-8,
            err_msg=k,
        )


def test_fit_resume_requires_path():
    _, ctx, cc = _compile()
    with pytest.raises(ValueError, match="checkpoint_path"):
        fit(cc, _data(32), store=dict(ctx.parameters), checkpoint_every=1)


def test_fit_checkpoint_every_zero_raises(tmp_path):
    _, ctx, cc = _compile()
    with pytest.raises(ValueError, match="checkpoint_every"):
        fit(
            cc, _data(32), store=dict(ctx.parameters),
            checkpoint_every=0, checkpoint_path=str(tmp_path / "ck"),
        )
    with pytest.raises(ValueError, match="checkpoint_every"):
        fit_em(
            cc, _data(32), store=dict(ctx.parameters),
            checkpoint_every=0, checkpoint_path=str(tmp_path / "ck"),
        )


def test_fit_resume_schedule_mismatch_raises(tmp_path):
    """Exact resume replays the batch schedule; different data or
    batch_size must be rejected, not silently diverge."""
    data = _data(64)
    ck = tmp_path / "ck"
    _, ctx, cc = _compile()
    fit(
        cc, data, store=dict(ctx.parameters), num_epochs=1, batch_size=16,
        checkpoint_every=1, checkpoint_path=str(ck),
    )
    _, ctx2, cc2 = _compile()
    with pytest.raises(ValueError, match="different run"):
        fit(
            cc2, data, store=dict(ctx2.parameters), num_epochs=1, batch_size=32,
            checkpoint_path=str(ck), resume=True,
        )
    other = _data(64, seed=99)
    with pytest.raises(ValueError, match="different run"):
        fit(
            cc2, other, store=dict(ctx2.parameters), num_epochs=1, batch_size=16,
            checkpoint_path=str(ck), resume=True,
        )


def test_fit_resume_beyond_run_raises(tmp_path):
    data = _data(64)
    ck = tmp_path / "ck"
    _, ctx, cc = _compile()
    fit(
        cc, data, store=dict(ctx.parameters), num_epochs=2, batch_size=16,
        checkpoint_every=1, checkpoint_path=str(ck),
    )
    _, ctx2, cc2 = _compile()
    with pytest.raises(ValueError, match="beyond this run"):
        fit(
            cc2, data, store=dict(ctx2.parameters), num_epochs=1, batch_size=16,
            checkpoint_path=str(ck), resume=True,
        )


def test_fit_em_resume_continues_epochs(tmp_path):
    data = _data(n=80, seed=3)
    ck = tmp_path / "em_ck"

    _, ctx, cc = _compile(em_ready=True, seed=5)
    full_store, full_losses = fit_em(
        cc, data, store=dict(ctx.parameters), num_epochs=3, batch_size=40,
    )

    # "killed" after epoch 2: a shorter run whose checkpoint survives
    _, ctx2, cc2 = _compile(em_ready=True, seed=5)
    fit_em(
        cc2, data, store=dict(ctx2.parameters), num_epochs=2, batch_size=40,
        checkpoint_every=1, checkpoint_path=str(ck),
    )

    _, ctx3, cc3 = _compile(em_ready=True, seed=5)
    store, losses = fit_em(
        cc3, data, store=dict(ctx3.parameters), num_epochs=3, batch_size=40,
        checkpoint_every=1, checkpoint_path=str(ck), resume=True,
    )
    assert len(losses) == len(full_losses)
    np.testing.assert_allclose(losses, full_losses, rtol=1e-8)
    for k in full_store:
        np.testing.assert_allclose(
            np.asarray(store[k]), np.asarray(full_store[k]), rtol=1e-8,
            err_msg=k,
        )


def test_fit_sigterm_checkpoints_and_resumes(tmp_path):
    """Graceful preemption: SIGTERM during a checkpointing fit() writes a
    final checkpoint and raises Preempted; the resumed run reproduces the
    uninterrupted one (preemptible machines signal eviction this way)."""
    import os
    import signal

    from cirkit_tpu.parallel import Preempted

    data = _data()
    ck = tmp_path / "fit_ck"

    _, ctx, cc = _compile()
    full_store, full_losses = fit(
        cc, data, store=dict(ctx.parameters), num_epochs=2, batch_size=32,
        optimizer=optax.adam(0.05),
    )

    _, ctx2, cc2 = _compile()

    def evictor(epoch, step, loss):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(Preempted, match="resume=True"):
        fit(
            cc2, data, store=dict(ctx2.parameters), num_epochs=2, batch_size=32,
            optimizer=optax.adam(0.05), callback=evictor,
            checkpoint_every=100, checkpoint_path=str(ck),
        )
    # the default handlers are back in place after the raise
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL

    _, ctx3, cc3 = _compile()
    store, losses = fit(
        cc3, data, store=dict(ctx3.parameters), num_epochs=2, batch_size=32,
        optimizer=optax.adam(0.05),
        checkpoint_every=100, checkpoint_path=str(ck), resume=True,
    )
    np.testing.assert_allclose(losses, full_losses, rtol=1e-8)
    for k in full_store:
        np.testing.assert_allclose(
            np.asarray(store[k]), np.asarray(full_store[k]), rtol=1e-8,
            err_msg=k,
        )


def test_fit_em_sigterm_checkpoints_and_resumes(tmp_path):
    import os
    import signal

    from cirkit_tpu.parallel import Preempted

    data = _data(n=80, seed=3)
    ck = tmp_path / "em_ck"

    _, ctx, cc = _compile(em_ready=True, seed=5)
    full_store, full_losses = fit_em(
        cc, data, store=dict(ctx.parameters), num_epochs=3, batch_size=40,
    )

    # a step-size schedule that pulls the trigger at the second M-step
    def evicting_schedule(t):
        if t == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return 1.0

    _, ctx2, cc2 = _compile(em_ready=True, seed=5)
    with pytest.raises(Preempted, match="resume=True"):
        fit_em(
            cc2, data, store=dict(ctx2.parameters), num_epochs=3, batch_size=40,
            step_size=evicting_schedule,
            checkpoint_every=100, checkpoint_path=str(ck),
        )

    _, ctx3, cc3 = _compile(em_ready=True, seed=5)
    store, losses = fit_em(
        cc3, data, store=dict(ctx3.parameters), num_epochs=3, batch_size=40,
        checkpoint_every=100, checkpoint_path=str(ck), resume=True,
    )
    np.testing.assert_allclose(losses, full_losses, rtol=1e-8)
    for k in full_store:
        np.testing.assert_allclose(
            np.asarray(store[k]), np.asarray(full_store[k]), rtol=1e-8,
            err_msg=k,
        )


@pytest.mark.slow
def test_grow_prune_loop_resume_after_kill(tmp_path, monkeypatch):
    from cirkit_tpu.backend.jax import pruning

    data = _data(n=64, seed=7)
    kwargs = dict(
        rounds=1, grow_fraction=0.25, prune_fraction=0.25, noise=0.0,
        em_epochs=2, batch_size=32, seed=0,
    )

    sc, ctx, _ = _compile(em_ready=True, seed=9)
    best_sc, best_store, history = pruning.grow_prune_loop(
        sc, data, ctx=ctx, **kwargs
    )

    # kill during the prune stage (after init + grow checkpoints landed)
    real_prune = pruning.prune_circuit
    calls = {"n": 0}

    def exploding_prune(*a, **k):
        calls["n"] += 1
        raise _Killed

    sc2, ctx2, _ = _compile(em_ready=True, seed=9)
    monkeypatch.setattr(pruning, "prune_circuit", exploding_prune)
    with pytest.raises(_Killed):
        pruning.grow_prune_loop(
            sc2, data, ctx=ctx2, checkpoint_dir=str(tmp_path / "loop"), **kwargs
        )
    monkeypatch.setattr(pruning, "prune_circuit", real_prune)
    assert calls["n"] == 1 and (tmp_path / "loop" / "LATEST").exists()

    sc3, ctx3, _ = _compile(em_ready=True, seed=9)
    r_sc, r_store, r_history = pruning.grow_prune_loop(
        sc3, data, ctx=ctx3, checkpoint_dir=str(tmp_path / "loop"), resume=True,
        **kwargs
    )
    assert [(s, u) for s, u, _ in r_history] == [(s, u) for s, u, _ in history]
    np.testing.assert_allclose(
        [ll for *_, ll in r_history], [ll for *_, ll in history], rtol=1e-6
    )
    # the resumed best is a working (circuit, store) pair of matching quality
    cc = PipelineContext(semiring="lse-sum", fold=True).compile(r_sc)
    ll = float(evaluate_ll(cc, data, store=r_store))
    np.testing.assert_allclose(ll, max(h[2] for h in history), rtol=1e-6)


def test_grow_prune_loop_resume_replays_early_stop(tmp_path, monkeypatch):
    """A checkpoint left by a run that legitimately early-stopped (its last
    round did not improve) must NOT trigger extra rounds on resume."""
    import cirkit_tpu.parallel as parallel
    from cirkit_tpu.backend.jax import pruning

    data = _data(n=48, seed=13)
    kwargs = dict(
        rounds=3, grow_fraction=0.25, prune_fraction=0.25, noise=0.0,
        em_epochs=1, batch_size=48, seed=0,
    )
    # decreasing held-out LL: init is best, round 0 never improves -> stop
    lls = iter(np.arange(100.0, 0.0, -1.0))
    calls = {"n": 0}

    def fake_ll(*a, **k):
        calls["n"] += 1
        return next(lls)

    monkeypatch.setattr(parallel, "evaluate_ll", fake_ll)
    sc, ctx, _ = _compile(em_ready=True, seed=17)
    _, _, history = pruning.grow_prune_loop(
        sc, data, ctx=ctx, checkpoint_dir=str(tmp_path / "loop"), **kwargs
    )
    assert len(history) == 3  # init + grow@0 + prune@0, then early stop
    n_before = calls["n"]

    sc2, ctx2, _ = _compile(em_ready=True, seed=17)
    _, _, r_history = pruning.grow_prune_loop(
        sc2, data, ctx=ctx2, checkpoint_dir=str(tmp_path / "loop"), resume=True,
        **kwargs
    )
    assert calls["n"] == n_before, "resume must not train/evaluate anything"
    assert [(s, u) for s, u, _ in r_history] == [(s, u) for s, u, _ in history]
