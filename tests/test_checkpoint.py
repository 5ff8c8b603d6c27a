"""Checkpoint / deterministic-resume tests (new capability — SURVEY.md §5:
the reference keeps weights only in process memory)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfbsdejsolvers_tpu.models.merton import make_merton_default
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
from deepfbsdejsolvers_tpu.solvers.train import fit, make_adam
from deepfbsdejsolvers_tpu.utils.checkpointing import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)


def tree_allclose(a, b):
    return all(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x, y: bool(jnp.allclose(x, y)), a, b)))


def test_roundtrip_params_and_key(tmp_path):
    solver = PricingSolver(make_merton_default(), "global")
    params = solver.init_params(jax.random.key(0))
    key = jax.random.key(123)
    state = (params, key, 7)
    save_checkpoint(str(tmp_path / "ck"), state)
    params2, key2, step = restore_checkpoint(str(tmp_path / "ck"), state)
    assert step == 7
    assert tree_allclose(params, params2)
    # the PRNG key survives the key_data round trip bit-exactly
    assert jnp.array_equal(jax.random.key_data(key), jax.random.key_data(key2))


def test_manager_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"x": jnp.asarray(float(step))})
    assert mgr.latest_step() == 3
    step, state = mgr.restore_latest({"x": jnp.asarray(0.0)})
    assert step == 3 and float(state["x"]) == 3.0
    # oldest pruned
    assert len(mgr._step_dirs()) == 2


def test_resume_is_deterministic(tmp_path):
    """Training E epochs straight equals training k, checkpointing, resuming
    for E-k — the fold_in epoch keys make the noise stream restart-invariant."""
    # N=10: restart-invariance of the key folding doesn't need the
    # production N=50 scan (compile time dominates this CPU test).
    solver = PricingSolver(
        dataclasses.replace(make_merton_default(), N=10), "global")
    key = jax.random.key(5)
    params0 = solver.init_params(jax.random.key(1))
    loss_fn = solver.build_loss(8)
    common = dict(loss_fn=loss_fn, lrate=1e-3, num_epoch=2,
                  y0_fn=solver.y0_estimate, verbose=False)

    # uninterrupted: 3 outer epochs
    res_full = fit(params=params0, key=key, num_epoch_ext=3, **common)

    # interrupted at epoch 1, checkpoint, fresh-process-style resume
    saved = {}

    def on_epoch(i, metrics, state):
        if i == 1:
            save_checkpoint(str(tmp_path / "ck"), state)

    fit(params=params0, key=key, num_epoch_ext=2, on_epoch=on_epoch, **common)
    opt_example = make_adam(1e-3).init(params0)
    params_r, opt_r, key_r = restore_checkpoint(
        str(tmp_path / "ck"), (params0, opt_example, key))
    res_resumed = fit(params=params_r, key=key_r, num_epoch_ext=3,
                      start_epoch=2, opt_state=opt_r, **common)

    assert res_resumed.y0_history[-1] == pytest.approx(
        res_full.y0_history[-1], rel=1e-6)
    assert tree_allclose(res_full.params, res_resumed.params)


@pytest.mark.full
def test_resume_is_deterministic_under_mesh(tmp_path):
    """Resume invariance must also hold on the SPMD path (before round 4
    resume was certified single-device only): training 3 outer
    epochs straight on an 8-device data mesh equals train-2 / checkpoint /
    restore / resume-for-1 on the same mesh — fit() folds per-epoch keys
    from the epoch index and each shard folds its own batch key from the
    mesh coordinate, so the global noise stream is restart-invariant."""
    from deepfbsdejsolvers_tpu.parallel import make_mesh

    mesh = make_mesh((8,), ("data",))
    solver = PricingSolver(make_merton_default(), "global")
    key = jax.random.key(5)
    params0 = solver.init_params(jax.random.key(1))
    loss_fn = solver.build_loss(8)  # per-shard batch
    common = dict(loss_fn=loss_fn, lrate=1e-3, num_epoch=2,
                  y0_fn=solver.y0_estimate, verbose=False, mesh=mesh)

    res_full = fit(params=params0, key=key, num_epoch_ext=3, **common)

    def on_epoch(i, metrics, state):
        if i == 1:
            save_checkpoint(str(tmp_path / "ck"), state)

    fit(params=params0, key=key, num_epoch_ext=2, on_epoch=on_epoch, **common)
    opt_example = make_adam(1e-3).init(params0)
    params_r, opt_r, key_r = restore_checkpoint(
        str(tmp_path / "ck"), (params0, opt_example, key))
    res_resumed = fit(params=params_r, key=key_r, num_epoch_ext=3,
                      start_epoch=2, opt_state=opt_r, **common)

    assert res_resumed.y0_history[-1] == pytest.approx(
        res_full.y0_history[-1], rel=1e-6)
    assert tree_allclose(res_full.params, res_resumed.params)


def test_restore_keeps_leaf_kinds_and_dtypes(tmp_path):
    """Python scalars come back as Python scalars, arrays with the
    example's dtype (bf16 and int32 included), numpy arrays as numpy."""
    state = {"step": 3, "lr": 0.5, "flag": True,
             "w": jnp.arange(4, dtype=jnp.bfloat16),
             "count": jnp.asarray(7, jnp.int32), "host": np.ones(2)}
    save_checkpoint(str(tmp_path / "ck"), state)
    back = restore_checkpoint(str(tmp_path / "ck"), state)
    assert back["step"] == 3 and type(back["step"]) is int
    assert back["lr"] == 0.5 and type(back["lr"]) is float
    assert back["flag"] is True
    assert back["w"].dtype == jnp.bfloat16 and isinstance(back["w"], jax.Array)
    assert back["count"].dtype == jnp.int32 and int(back["count"]) == 7
    assert isinstance(back["host"], np.ndarray)


def test_restore_rejects_mismatched_example(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"a": jnp.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path / "ck"),
                           {"a": jnp.zeros(2), "b": jnp.zeros(2)})


def test_checkpoint_file_holds_arrays_only(tmp_path):
    """The state file is a plain npz of the flattened leaves: it loads
    with pickling disabled and holds nothing but arr_<i> entries."""
    import os

    save_checkpoint(str(tmp_path / "ck"), (jnp.ones(3), jax.random.key(1), 5))
    path = tmp_path / "ck" / "state.npz"
    with np.load(path, allow_pickle=False) as data:
        assert sorted(data.files) == sorted(
            f"arr_{i}" for i in range(len(data.files)))
    assert os.listdir(tmp_path / "ck") == ["state.npz"]


def test_save_overwrites_previous_checkpoint(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"x": jnp.asarray(1.0)})
    save_checkpoint(path, {"x": jnp.asarray(2.0)})
    assert float(restore_checkpoint(path, {"x": jnp.asarray(0.0)})["x"]) == 2.0
