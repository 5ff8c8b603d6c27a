#!/usr/bin/env python
"""A/B the time-scan chunking knob on the round-3 speed config.

Scan-buffer traffic (dynamic_update_slice stacking of saved heads +
per-step xs reads) and kernel-gap idle are per-step costs of the flat scan.
``PricingSolver.scan_chunk``
replaces the flat N-step lax.scan with an outer scan over N/k chunks of k
fully-unrolled steps (static xs indexing, chunk-boundary remat) — this
script measures whether that converts the buffer traffic into throughput.

Usage:
  python scripts/scan_chunk_ab.py [--batch 131072] \
      [--chunks 0,2,5,10,25] [--inner 10] [--model merton|vg]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def measure_one(batch, inner, chunk, model_name="merton",
                compensator="quadrature"):
    from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_tpu.solvers.train import make_adam, make_epoch_fn

    if model_name == "mfg":
        import dataclasses

        from deepfbsdejsolvers_tpu.models.mfg_smart_grid import make_mfg_default
        from deepfbsdejsolvers_tpu.solvers.mfg import MFGSolver

        model = dataclasses.replace(make_mfg_default(), jump_sampler="icdf")
        solver = MFGSolver(model, "global", scan_chunk=chunk)
        params = solver.init_params(jax.random.key(0))
        optimizer = make_adam(1e-3)
        opt_state = optimizer.init(params)
        loss_fn = solver.build_losses(batch)["coupled"]
        epoch = make_epoch_fn(loss_fn, optimizer, inner)
        key = jax.random.key(1)
        for w in range(2):
            params, opt_state, loss = epoch(params, opt_state,
                                            jax.random.fold_in(key, 1000 + w))
            jax.block_until_ready(loss)
        times = []
        for r in range(5):
            t0 = time.perf_counter()
            params, opt_state, loss = epoch(params, opt_state,
                                            jax.random.fold_in(key, r))
            jax.block_until_ready(loss)
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        return batch * model.N * inner / med, times, float(loss)
    if model_name == "vg":
        import dataclasses

        from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

        model = dataclasses.replace(make_vg_default(jump_sampler="icdf"),
                                    price_eval="chebyshev")
    else:
        from deepfbsdejsolvers_tpu.models.merton import make_merton_default

        model = make_merton_default(jump_sampler="icdf",
                                    price_mode="chebyshev")
    solver = PricingSolver(
        model, "global",
        compensator=CompensatorSpec(kind=compensator,
                                    x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise", scan_chunk=chunk)
    params = solver.init_params(jax.random.key(0))
    optimizer = make_adam(4e-4)
    opt_state = optimizer.init(params)
    loss_fn = solver.build_loss(batch)
    epoch = make_epoch_fn(loss_fn, optimizer, inner)
    key = jax.random.key(1)
    for w in range(2):
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, 1000 + w))
        jax.block_until_ready(loss)
    times = []
    for r in range(5):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    return batch * model.N * inner / med, times, float(loss)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--chunks", type=str, default="0,2,5,10,25")
    p.add_argument("--model", choices=["merton", "vg", "mfg"],
                   default="merton")
    p.add_argument("--compensator", choices=["quadrature", "mc"],
                   default="quadrature")
    args = p.parse_args()

    for chunk in map(int, args.chunks.split(",")):
        try:
            rate, times, loss = measure_one(args.batch, args.inner, chunk,
                                            args.model, args.compensator)
            print(f"chunk={chunk:<3d} {rate:.3e}  "
                  f"med={sorted(times)[len(times)//2]*1e3:.1f}ms  "
                  f"loss={loss:.6f}", flush=True)
        except Exception as e:
            print(f"chunk={chunk:<3d} FAIL {type(e).__name__}: "
                  f"{str(e)[:200]}", flush=True)


if __name__ == "__main__":
    main()
