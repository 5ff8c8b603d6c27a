#!/usr/bin/env python
"""Bring-up check: the Merton deep-BSDE trainer on one NVIDIA GPU.

Drives the entry points a user calls — ``bench.build``/``bench.measure``
(``PricingSolver`` + ``make_epoch_fn``), ``solvers.train.fit`` and the gate
registry of ``scripts/convergence_gates.py`` — at the headline model's full
width: N=50 time steps, (21, 21) tanh heads, 2^17 paths per step, the speed
config of ``bench.py``.  Weights are random, made from fixed seeds.

Phases of ``python chip_smoke.py`` (one GPU):

1. device      nvidia-smi name and power limit, JAX version and devices,
               XLA_FLAGS, compile-cache directory; refuses anything but a GPU.
2. headline    compile + 2 warm-up + 3 timed epochs of 10 Adam steps.
3. gpu vs cpu  speed-config loss and gradient at 2^14 paths, fixed params and
               key, on the GPU and on the host CPU: under HIGHEST matmul
               precision (tight), and at the program's own precision policy.
4. select      pw_eval / pw2_eval on the GPU at 2^17 points against a float64
               NumPy evaluation of the same coefficients.
5. accuracy    one seed of the merton_speed gate at its shipped budget
               (batch 8192, 2400 steps): |Y0 - closed form| <= 1e-3.
6. families    a few training steps each of the VG and MFG speed configs and
               of the Merton parity config (direct 49-node XLA sweep).
7. result      the last line: {"ok": true, "device": {...}}.

``python chip_smoke.py --devices 4`` runs only the multi-GPU phase: the speed
config through ``fit(mesh=...)`` on a 4-way data mesh and the direct
quadrature config on a 2x2 (data, comp) mesh, each against the gradient of
the same mesh-mean loss computed on one GPU.

Any failed check raises: the script then exits non-zero and prints no result
line.  So does a host where JAX finds no GPU, and a directory without the
rest of the repository.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BATCH = 2 ** 17          # headline paths per training step
CMP_BATCH = 2 ** 14      # GPU-vs-CPU comparison batch (widths unchanged)
# Phase 3 bars under HIGHEST: both backends run the same f32 program on the
# same threefry bits; what differs is f32 summation order and the
# transcendental implementations, compounded over 50 steps (and, for the
# gradient, the |Y - A| coupling kink, where a path within rounding of the
# kink may take the other subgradient).  Measured on an H100 80GB HBM3 at
# 700 W: loss identical, gradient 2.1e-5 relative — the bars leave ~5x.
# The same bars hold a device mesh against one device (--devices 4).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# Phase 4 bar: max |got - ref| over the evaluated point's coefficient mass
# sum_k |c_k|, in units of f32 epsilon.  An f32 Clenshaw chain of these
# degrees stays within a few eps (6.4 and 3.4 on an H100 80GB HBM3 at
# 700 W); a TF32 select rounds each coefficient to ~2^-11 relative (a
# DEFAULT-precision one-hot select measured 893 eps there).
SELECT_EPS = 32
F32_EPS = 2.0 ** -23
GATE_BAR = 1e-3


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else (
        f"nvidia-smi failed (rc={out.returncode})")


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU: a CPU result is not a card
    result."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX reports {kind!r}")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over two pytrees of the same structure."""
    import jax
    import numpy as np

    fa = np.concatenate([np.ravel(np.asarray(x, np.float64))
                         for x in jax.tree_util.tree_leaves(a)])
    fb = np.concatenate([np.ravel(np.asarray(x, np.float64))
                         for x in jax.tree_util.tree_leaves(b)])
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


# ------------------------------------------------------------------ phases
def phase_device(card: str):
    import jax

    from deepfbsdejsolvers_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devices = jax.devices()
    print(f"[1 device] nvidia-smi: {card}")
    print(f"[1 device] jax {jax.__version__}  devices={devices}")
    print(f"[1 device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}  "
          f"compile cache={cache}")
    require_gpu(devices)
    return devices


def phase_headline(card: str, batch: int = BATCH, inner: int = 10,
                   rounds: int = 3) -> dict:
    import numpy as np

    import bench

    res = bench.measure(batch, inner, rounds, "quadrature")
    print(f"[2 headline] merton speed config N=50 (21,21) batch {batch}: "
          f"compile {res['compile_seconds']:.1f} s, "
          f"{res['paths_steps_per_sec']:.4e} paths*steps/s, "
          f"final loss {res['final_loss']:.6g}  [{card}]")
    print(f"[2 headline] epoch seconds {res['round_seconds']}  "
          f"peak device bytes {res['peak_bytes']}")
    check(np.isfinite(res["final_loss"]), "headline loss is not finite")
    return res


def loss_and_grad(loss_fn, params, key, device, precision=None):
    """(loss, grads) of ``loss_fn`` jitted on ``device``, traced under
    ``precision`` (None = the program's own policy)."""
    import contextlib

    import jax

    params, key = jax.device_put((params, key), device)
    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, key)
    return float(loss), jax.device_get(grads)


def phase_gpu_vs_cpu(batch: int = CMP_BATCH) -> dict:
    import jax

    import bench

    _, _, params, _, _, loss_fn = bench.build(batch, "quadrature", False)
    key = jax.random.key(1)
    device = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    l_cpu, g_cpu = loss_and_grad(loss_fn, params, key, cpu, "highest")
    l_hi, g_hi = loss_and_grad(loss_fn, params, key, device, "highest")
    l_own, g_own = loss_and_grad(loss_fn, params, key, device)
    out = {"loss_cpu": l_cpu,
           "loss_rel_highest": abs(l_hi - l_cpu) / abs(l_cpu),
           "grad_rel_highest": rel_l2(g_hi, g_cpu),
           "loss_rel_own": abs(l_own - l_cpu) / abs(l_cpu),
           "grad_rel_own": rel_l2(g_own, g_cpu)}
    print(f"[3 gpu-vs-cpu] batch {batch}: {json.dumps(out)}")
    check(out["loss_rel_highest"] <= LOSS_RTOL,
          f"HIGHEST loss differs from CPU by {out['loss_rel_highest']:.3g}"
          f" > {LOSS_RTOL}")
    check(out["grad_rel_highest"] <= GRAD_RTOL,
          f"HIGHEST gradient differs from CPU by {out['grad_rel_highest']:.3g}"
          f" > {GRAD_RTOL}")
    return out


def _clenshaw64(c, t):
    """sum_k c[..., k] T_k(t) in float64 (c: (..., D), t broadcastable)."""
    import numpy as np

    b1 = np.zeros(np.broadcast(c[..., 0], t).shape)
    b2 = b1
    for k in range(c.shape[-1] - 1, 0, -1):
        b1, b2 = c[..., k] + 2.0 * t * b1 - b2, b1
    return c[..., 0] + t * b1 - b2


def _local64(x, p):
    """(piece, local coordinate) of points x on [0, 1] with p pieces, in
    float64 — the same clamp-and-floor as ops/piecewise."""
    import numpy as np

    s = np.clip(x.astype(np.float64), 0.0, 1.0) * p
    k = np.clip(np.floor(s), 0, p - 1)
    return k.astype(np.int64), 2.0 * (s - k) - 1.0


def select_points(key, n: int):
    """n points on [0, 1] (plus clamped ones outside) at multiples of
    2^-20: on the interval [0, 1] every piece index and local coordinate
    is then exact in f32, so the only f32 error left is the evaluation's."""
    import jax
    import jax.numpy as jnp

    m = jax.random.randint(key, (n,), 0, 2 ** 20 + 1)
    x = m.astype(jnp.float32) * 2.0 ** -20
    return x.at[:2].set(jnp.asarray([-0.5, 1.5], jnp.float32))


def piece_select_errors(batch: int, key=None) -> dict:
    """Scaled max errors of pw_eval / pw2_eval against float64 NumPy, at
    ``batch`` points, run on the default device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepfbsdejsolvers_tpu.ops.piecewise import pw2_eval, pw_eval

    key = jax.random.key(7) if key is None else key
    kc, kc2, kx, kj = jax.random.split(key, 4)
    p, d = 8, 8
    px, dx, pj, dj = 8, 7, 4, 4
    coef = jax.random.normal(kc, (p, d), jnp.float32)
    coef2 = jax.random.normal(kc2, (px * pj, (dx + 1) * (dj + 1)), jnp.float32)
    x = select_points(kx, batch)
    j = select_points(kj, batch)
    got1 = np.asarray(jax.jit(pw_eval)(coef, x, 0.0, 1.0), np.float64)
    got2 = np.asarray(jax.jit(
        lambda c, x, j: pw2_eval(c, x, j, 0.0, 1.0, 0.0, 1.0, px, dx, pj, dj)
    )(coef2, x, j), np.float64)

    c64 = np.asarray(coef, np.float64)
    xs, js = np.asarray(x), np.asarray(j)
    k, t = _local64(xs, p)
    rows = c64[k]
    ref1 = _clenshaw64(rows, t)
    err1 = np.max(np.abs(got1 - ref1) / np.sum(np.abs(rows), -1))

    kx_, tx = _local64(xs, px)
    kj_, tj = _local64(js, pj)
    rows2 = np.asarray(coef2, np.float64)[kx_ * pj + kj_].reshape(
        batch, dx + 1, dj + 1)
    ref2 = _clenshaw64(_clenshaw64(rows2, tj[:, None]), tx)
    err2 = np.max(np.abs(got2 - ref2) / np.sum(np.abs(rows2), (-2, -1)))

    # what a DEFAULT-precision one-hot matmul select (the old policy) does
    # to the coefficients on this device — recorded, not gated
    onehot = (jnp.asarray(k)[:, None] == jnp.arange(p)).astype(jnp.float32)
    sel = np.asarray(jax.jit(jnp.matmul)(onehot, coef), np.float64)
    err_default = np.max(np.abs(sel - rows)
                         / np.sum(np.abs(rows), -1, keepdims=True))
    return {"pw_eval": float(err1 / F32_EPS), "pw2_eval": float(err2 / F32_EPS),
            "default_onehot_select": float(err_default / F32_EPS)}


def phase_piece_select(batch: int = BATCH) -> dict:
    errs = piece_select_errors(batch)
    print(f"[4 select] batch {batch}, scaled max error in f32 eps "
          f"(bar {SELECT_EPS}): {json.dumps(errs)}")
    for name in ("pw_eval", "pw2_eval"):
        check(errs[name] <= SELECT_EPS,
              f"{name} is {errs[name]:.1f} eps from float64 > {SELECT_EPS}")
    return errs


def phase_accuracy(card: str, **budget) -> dict:
    cg = _load_script("convergence_gates")
    registry = cg.build_registry()
    t0 = time.perf_counter()
    rec = cg.run_entry("merton_speed", registry["merton_speed"], seeds=1,
                       **budget)
    print(f"[5 accuracy] merton_speed 1 seed: |Y0 - closed form| = "
          f"{rec['abs_error']:.3e} (bar {GATE_BAR}), "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    check(rec["abs_error"] <= GATE_BAR,
          f"merton_speed error {rec['abs_error']:.3e} > {GATE_BAR}")
    return rec


def phase_families(card: str, batch: int = BATCH, inner: int = 5) -> dict:
    import numpy as np

    import bench

    out = {}
    for tag, kw in (("vg_speed", dict(model_name="vg")),
                    ("mfg_speed", dict(model_name="mfg")),
                    ("merton_parity", dict(parity=True))):
        res = bench.measure(batch, inner, 1, "quadrature", **kw)
        out[tag] = res
        print(f"[6 families] {tag} batch {batch}: compile "
              f"{res['compile_seconds']:.1f} s, "
              f"{res['paths_steps_per_sec']:.4e} paths*steps/s, final loss "
              f"{res['final_loss']:.6g}  [{card}]")
        check(np.isfinite(res["final_loss"]), f"{tag} loss is not finite")
    return out


def _serial_mean_loss(loss_fn, n: int):
    import jax
    import jax.numpy as jnp

    def serial(params, key):
        return jnp.mean(jnp.stack([
            loss_fn(params, jax.random.fold_in(key, i)) for i in range(n)]))

    return serial


def phase_multi(card: str, n_dev: int, speed_batch: int, direct_batch: int,
                inner: int = 10) -> dict:
    """Data-parallel speed config (fit(mesh=...)) and the 2x2 (data, comp)
    direct quadrature config, each against one device."""
    import jax
    import numpy as np

    import bench
    from deepfbsdejsolvers_tpu.models.merton import make_merton_default
    from deepfbsdejsolvers_tpu.parallel.data_parallel import (
        make_dp_loss, make_mesh)
    from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_tpu.solvers.train import fit

    devices = jax.devices()[:n_dev]
    check(len(devices) == n_dev, f"need {n_dev} devices, have {len(devices)}")
    one = devices[0]
    key = jax.random.key(1)
    out = {}

    model, solver, params, _, _, loss_fn = bench.build(
        speed_batch, "quadrature", False)
    mesh = make_mesh((n_dev,), devices=devices)
    with jax.default_matmul_precision("highest"):
        l_dp, g_dp = jax.jit(jax.value_and_grad(make_dp_loss(loss_fn, mesh)))(
            params, key)
    l_1, g_1 = loss_and_grad(_serial_mean_loss(loss_fn, n_dev), params, key,
                             one, "highest")
    out["speed_loss_rel"] = abs(float(l_dp) - l_1) / abs(l_1)
    out["speed_grad_rel"] = rel_l2(jax.device_get(g_dp), g_1)
    res = fit(loss_fn, params, key, lrate=4e-4, num_epoch=inner,
              num_epoch_ext=3, mesh=mesh, verbose=False)
    epoch_s = res.duration_history[-1] - res.duration_history[-2]
    out["dp_epoch_seconds"] = epoch_s
    out["dp_paths_steps_per_sec"] = (speed_batch * n_dev * model.N * inner
                                     / epoch_s)
    out["dp_final_loss"] = res.loss_history[-1]
    check(np.isfinite(res.loss_history[-1]), "DP fit loss is not finite")

    n_data = n_dev // 2
    direct = make_merton_default()
    base = PricingSolver(direct, "global")
    sharded = PricingSolver(direct, "global", comp_axis="comp", comp_shards=2)
    params_d = base.init_params(jax.random.key(0))
    mesh2 = make_mesh((n_data, 2), ("data", "comp"), devices=devices)
    with jax.default_matmul_precision("highest"):
        l_sh, g_sh = jax.jit(jax.value_and_grad(
            make_dp_loss(sharded.build_loss(direct_batch), mesh2)))(
                params_d, key)
    l_b, g_b = loss_and_grad(
        _serial_mean_loss(base.build_loss(direct_batch), n_data), params_d,
        key, one, "highest")
    out["direct_loss_rel"] = abs(float(l_sh) - l_b) / abs(l_b)
    out["direct_grad_rel"] = rel_l2(jax.device_get(g_sh), g_b)
    print(f"[E multi] {n_dev} devices, speed per-shard batch {speed_batch}, "
          f"direct per-shard batch {direct_batch}: {json.dumps(out)}  "
          f"[{card}]")
    for tag in ("speed", "direct"):
        check(out[f"{tag}_loss_rel"] <= LOSS_RTOL,
              f"{tag} mesh loss differs from one device by "
              f"{out[f'{tag}_loss_rel']:.3g} > {LOSS_RTOL}")
        check(out[f"{tag}_grad_rel"] <= GRAD_RTOL,
              f"{tag} mesh gradient differs from one device by "
              f"{out[f'{tag}_grad_rel']:.3g} > {GRAD_RTOL}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="4: run only the multi-GPU phase and its comparison")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)

    card = card_line()
    devices = phase_device(card)
    if args.devices == 4:
        phase_multi(card, 4, speed_batch=BATCH // 4, direct_batch=2 ** 14)
        devices = devices[:4]
    else:
        phase_headline(card)
        phase_gpu_vs_cpu()
        phase_piece_select()
        phase_accuracy(card)
        phase_families(card)
        devices = devices[:1]
    print(f"nvidia-smi: {card}")
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
