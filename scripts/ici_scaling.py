#!/usr/bin/env python
"""Multi-device scaling measurement + static collective accounting.

* ``--strong`` / ``--weak``: strong- and weak-scaling sweeps of the SPMD
  data-parallel epoch (``parallel.data_parallel.make_dp_epoch``) over
  ``jax.devices()`` — e.g. the GPUs of one host.  With ``--virtual`` it runs
  on the 8-device XLA-faked CPU mesh instead (shards share host cores:
  per-shard times are NOT device times, only the collective/SPMD structure
  is real).
* ``--collectives``: static accounting of the per-step gradient all-reduce
  from the COMPILED HLO of the DP update — op-by-op byte counts, summed.
  This is batch-independent (the all-reduced tensors are the param-sized
  gradients), so it holds for any hardware run.
* With ``--stepTime`` (a measured single-device train-step time, seconds)
  and ``--linkBw`` (a measured one-way per-device link bandwidth, bytes/s)
  the report adds a projection: step time vs the ideal ring all-reduce
  time  2·(n-1)/n · bytes / link_bw  at each world size.  Neither has a
  default: the projection uses only numbers measured by the caller.

Usage:
  python scripts/ici_scaling.py --collectives            # static accounting
  python scripts/ici_scaling.py --strong --weak          # measure on devices
  python scripts/ici_scaling.py --virtual --strong       # 8-dev CPU mesh
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def _build(per_shard: int, n_shards: int, inner: int):
    import jax

    from deepfbsdejsolvers_tpu.models.merton import make_merton_default
    from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_tpu.parallel.data_parallel import (
        make_dp_epoch, make_mesh)
    from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_tpu.solvers.train import make_adam

    model = make_merton_default(jump_sampler="icdf", price_mode="chebyshev")
    solver = PricingSolver(
        model, "global",
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise")
    params = solver.init_params(jax.random.key(0))
    optimizer = make_adam(4e-4)
    opt_state = optimizer.init(params)
    mesh = make_mesh((n_shards,), devices=jax.devices()[:n_shards])
    epoch = make_dp_epoch(solver.build_loss(per_shard), optimizer, mesh, inner)
    return model, params, opt_state, epoch


def measure(per_shard: int, n_shards: int, inner: int, rounds: int = 3):
    import jax

    model, params, opt_state, epoch = _build(per_shard, n_shards, inner)
    key = jax.random.key(1)
    for w in range(2):
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, 900 + w))
        jax.block_until_ready(loss)
    ts = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
        ts.append(time.perf_counter() - t0)
    med = sorted(ts)[len(ts) // 2]
    return {
        "n_shards": n_shards,
        "per_shard_batch": per_shard,
        "global_batch": per_shard * n_shards,
        "median_epoch_s": med,
        "global_paths_steps_per_sec": per_shard * n_shards * model.N * inner / med,
    }


_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "f64": 8, "s32": 4, "u32": 4,
                "pred": 1, "s8": 1, "u8": 1}


def collective_bytes(per_shard: int = 256, n_shards: int = 8, inner: int = 1):
    """Sum the bytes moved by every all-reduce/all-gather/reduce-scatter in
    the compiled HLO of one DP update step."""
    import jax

    _, params, opt_state, epoch = _build(per_shard, n_shards, inner)
    key = jax.random.key(1)
    txt = jax.jit(epoch).lower(params, opt_state, key).compile().as_text()
    ops = []
    # XLA groups the per-leaf gradient psums into ONE tuple-shaped op:
    #   %all-reduce.1 = (f32[3,21]{1,0}, f32[21,21]{1,0}, ...) all-reduce(...)
    # alongside scalar ones:  %psum.120 = f32[] all-reduce(...)
    line_pat = re.compile(
        r"%(\S+) = (.*?) (all-reduce|all-gather|reduce-scatter|all-to-all|"
        r"collective-permute)(?:-start)?\(")
    shape_pat = re.compile(r"(\w+)\[([\d,]*)\]")
    for line in txt.splitlines():
        m = line_pat.search(line)
        if not m or "get-tuple-element" in line:
            continue
        name, shapes, kind = m.groups()
        total_b = total_e = 0
        for dt, dims in shape_pat.findall(shapes):
            n_elem = 1
            for d in dims.split(","):
                if d:
                    n_elem *= int(d)
            total_e += n_elem
            total_b += n_elem * _DTYPE_BYTES.get(dt, 4)
        if not shape_pat.search(shapes):       # bare f32[] scalar
            total_e, total_b = 1, 4
        ops.append({"op": kind, "name": name, "elements": total_e,
                    "bytes": total_b})
    n_params = sum(x.size for x in jax.tree.leaves(params))
    return {
        "n_shards": n_shards,
        "param_count": n_params,
        "param_bytes_f32": 4 * n_params,
        "collective_ops": ops,
        "total_collective_bytes_per_step": sum(o["bytes"] for o in ops),
    }


def projection(step_time_s: float, coll_bytes: int, link_bw: float,
               world_sizes=(2, 4, 8, 16, 64, 256)):
    """Expected DP scaling efficiency with a ring all-reduce: the gradient
    all-reduce moves 2*(n-1)/n * bytes through each device's link;
    everything else is perfectly data-parallel (paths are independent)."""
    rows = []
    for n in world_sizes:
        t_ar = 2 * (n - 1) / n * coll_bytes / link_bw
        rows.append({
            "world": n,
            "allreduce_s": t_ar,
            "efficiency_overlap0": step_time_s / (step_time_s + t_ar),
        })
    return rows


def _add_projection(report, args):
    """Ring all-reduce projection from the caller's measured step time and
    link bandwidth; nothing is projected without both."""
    if args.stepTime is None or args.linkBw is None:
        report["projection_ring"] = None
        report["projection_note"] = "pass --stepTime and --linkBw to project"
        return
    report["projection_ring"] = projection(
        args.stepTime,
        report["collectives"]["total_collective_bytes_per_step"],
        args.linkBw)
    report["projection_note"] = (
        f"step_time={args.stepTime}s, link_bw={args.linkBw:.3g} B/s one-way "
        "(caller's measurements); efficiency_overlap0 assumes NO "
        "compute/comm overlap — the worst case")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--perShard", type=int, default=2**14)
    p.add_argument("--globalBatch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--strong", action="store_true")
    p.add_argument("--weak", action="store_true")
    p.add_argument("--collectives", action="store_true")
    p.add_argument("--stepTime", type=float, default=None,
                   help="measured single-device train-step seconds (needed "
                        "for the projection)")
    p.add_argument("--linkBw", type=float, default=None,
                   help="measured one-way per-device link bytes/s (needed "
                        "for the projection)")
    p.add_argument("--virtual", action="store_true",
                   help="re-exec on an 8-device XLA-faked CPU mesh")
    args = p.parse_args()

    if args.virtual and os.environ.get("_ICI_CHILD") != "1":
        env = dict(os.environ, _ICI_CHILD="1", JAX_PLATFORMS="cpu",
                   XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=8")
        argv = [a for a in sys.argv[1:] if a != "--virtual"]
        sys.exit(subprocess.call(
            [sys.executable, os.path.abspath(__file__)] + argv, env=env))

    if (args.collectives and not (args.strong or args.weak)
            and os.environ.get("_ICI_CHILD") != "1"):
        # pure accounting: never touch the accelerator from the parent (it
        # would reserve most of a card's memory that a concurrent job may
        # hold) — delegate straight to the CPU child
        env = dict(os.environ, _ICI_CHILD="1", JAX_PLATFORMS="cpu",
                   XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=8")
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--collectives"],
            env=env, capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stderr)
            sys.exit(out.returncode)
        report = json.loads(out.stdout[out.stdout.find("{"):])
        _add_projection(report, args)
        print(json.dumps(report, indent=1))
        return

    import jax

    if os.environ.get("_ICI_CHILD") == "1":
        jax.config.update("jax_platforms", "cpu")

    report = {"device": str(jax.devices()[0]), "n_devices": len(jax.devices())}
    ndev = len(jax.devices())
    shard_counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= ndev]

    if args.collectives:
        # reached with >= 2 local devices (or inside the child): the
        # single-device parent path above delegates before importing jax
        report["collectives"] = collective_bytes(n_shards=min(8, max(ndev, 2)))
        _add_projection(report, args)

    if args.strong:
        report["strong"] = [
            measure(max(1, args.globalBatch // n), n, args.inner)
            for n in shard_counts]
    if args.weak:
        report["weak"] = [measure(args.perShard, n, args.inner)
                          for n in shard_counts]

    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
