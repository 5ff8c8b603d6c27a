#!/usr/bin/env python
"""Weak-scaling measurement of the SPMD data-parallel path on a virtual mesh.

Fixed per-shard batch, 1 -> 8 data shards on XLA-faked CPU devices (for
real devices use scripts/ici_scaling.py --weak).  Perfect weak scaling = flat time per epoch as the
global batch grows with the shard count; on a virtual CPU mesh the shards
share physical cores, so the honest metric reported is global paths*steps/sec
vs shard count (should grow until the host cores saturate).

Usage: [XLA_FLAGS=...] python scripts/weak_scaling.py [--perShard 4096]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from deepfbsdejsolvers_tpu.models.merton import make_merton_default  # noqa: E402
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec  # noqa: E402
from deepfbsdejsolvers_tpu.parallel.data_parallel import (  # noqa: E402
    make_dp_epoch,
    make_mesh,
)
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver  # noqa: E402
from deepfbsdejsolvers_tpu.solvers.train import make_adam  # noqa: E402


def measure(n_shards: int, per_shard: int, inner: int = 10, rounds: int = 3):
    model = make_merton_default(jump_sampler="icdf", price_mode="chebyshev")
    solver = PricingSolver(
        model, "global",
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64))
    params = solver.init_params(jax.random.key(0))
    optimizer = make_adam(1e-3)
    opt_state = optimizer.init(params)
    mesh = make_mesh((n_shards,), devices=jax.devices()[:n_shards])
    epoch = make_dp_epoch(solver.build_loss(per_shard), optimizer, mesh, inner)
    key = jax.random.key(1)
    params, opt_state, loss = epoch(params, opt_state, key)  # compile
    jax.block_until_ready(loss)
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    paths_steps = per_shard * n_shards * model.N * inner
    return {"shards": n_shards, "per_shard_batch": per_shard,
            "epoch_seconds": med,
            "global_paths_steps_per_sec": paths_steps / med}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--perShard", type=int, default=4096)
    p.add_argument("--inner", type=int, default=10)
    args = p.parse_args()
    results = []
    for n in (1, 2, 4, 8):
        r = measure(n, args.perShard, args.inner)
        results.append(r)
        print(json.dumps(r), flush=True)
    base = results[0]["global_paths_steps_per_sec"]
    print(json.dumps({"weak_scaling_efficiency": {
        str(r["shards"]): r["global_paths_steps_per_sec"] / (base * r["shards"])
        for r in results}}), flush=True)


if __name__ == "__main__":
    main()
