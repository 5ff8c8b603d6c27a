#!/usr/bin/env python
"""Profile a bench.py training step and attribute its device time.

Three instruments:

1. ``--cost``: XLA's compiled cost model (``compiled.cost_analysis()``) —
   total FLOPs, transcendentals, and bytes accessed of one jitted epoch —
   combined with the measured wall-clock into achieved FLOP/s and B/s, and
   compared against the device's published peaks (``bench.PEAKS``, keyed
   by ``device_kind``; an unknown device is an error).
2. ``--trace DIR``: capture a jax.profiler device trace of a few epochs and
   reduce it (``utils/profiling.device_time_split``): device busy and idle
   share, the share of kernel time inside the compensator sweep's
   ``comp_sweep`` named scope, and the top HLO ops by device time.  The
   reduction is written to ``DIR/split.json``.
3. ``--ablate``: re-time the epoch under component knockouts (1-node
   compensator, coarser collocation, direct pricer, forward-only, no remat)
   — attribution by subtraction.

Usage:
  python scripts/profile_headline.py --cost --ablate
  python scripts/profile_headline.py --mode parity --trace chiprun_out/tr
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_epoch(batch, inner, mode="speed", model_name="merton",
                compensator="quadrature"):
    import jax

    from bench import build
    from deepfbsdejsolvers_tpu.solvers.train import make_epoch_fn

    model, solver, params, optimizer, opt_state, loss_fn = build(
        batch, compensator, parity=(mode == "parity"),
        model_name=model_name)
    epoch = make_epoch_fn(loss_fn, optimizer, inner)
    key = jax.random.key(1)
    return model, solver, params, optimizer, opt_state, loss_fn, epoch, key


def timed(epoch, params, opt_state, key, rounds=3, warmup=2):
    import jax

    for w in range(warmup):
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, 1000 + w))
        jax.block_until_ready(loss)
    ts = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def run_cost(batch, inner, mode, model_name="merton", compensator="quadrature"):
    import jax

    from bench import peaks_for

    model, solver, params, optimizer, opt_state, loss_fn, epoch, key = \
        build_epoch(batch, inner, mode, model_name, compensator)
    lowered = jax.jit(epoch).lower(params, opt_state, key)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):  # older jax returns [dict]
        ca = ca[0]
    peaks = peaks_for(jax.devices()[0].device_kind)
    med = timed(epoch, params, opt_state, key)
    flops = ca.get("flops", float("nan"))
    bytes_acc = ca.get("bytes accessed", float("nan"))
    trans = ca.get("transcendentals", float("nan"))
    out = {
        "mode": mode,
        "batch": batch,
        "inner": inner,
        "median_epoch_s": med,
        "paths_steps_per_sec": batch * model.N * inner / med,
        "xla_flops_per_epoch": flops,
        "xla_transcendentals_per_epoch": trans,
        "xla_bytes_accessed_per_epoch": bytes_acc,
        "achieved_flops_per_sec": flops / med,
        "achieved_bytes_per_sec": bytes_acc / med,
        "pct_of_f32_peak": 100 * flops / med / peaks["f32_flops"],
        "pct_of_hbm_peak": 100 * bytes_acc / med / peaks["hbm_bytes"],
        "arithmetic_intensity_flops_per_byte": flops / bytes_acc,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(out, indent=1))
    return out


def run_trace(batch, inner, mode, trace_dir, top=20, model_name="merton",
              compensator="quadrature"):
    import glob

    import jax

    from deepfbsdejsolvers_tpu.utils.profiling import (
        device_time_split, scope_weights)

    model, solver, params, optimizer, opt_state, loss_fn, epoch, key = \
        build_epoch(batch, inner, mode, model_name, compensator)
    compiled = epoch.lower(params, opt_state, key).compile()
    hlo = compiled.as_text()
    weights = scope_weights(hlo, "comp_sweep")
    # warm up fully so the trace holds steady-state epochs only
    for w in range(2):
        params, opt_state, loss = compiled(params, opt_state,
                                           jax.random.fold_in(key, 1000 + w))
        jax.block_until_ready(loss)
    jax.profiler.start_trace(trace_dir)
    for r in range(2):
        params, opt_state, loss = compiled(params, opt_state,
                                           jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    # XLA:CPU runs its kernels on the host plane; any accelerator has its own
    on_cpu = jax.devices()[0].platform == "cpu"
    split = device_time_split(path, weights, top,
                              plane_prefix="/host:CPU" if on_cpu else "/device:")
    split.update(mode=mode, model=model_name, compensator=compensator,
                 batch=batch, inner=inner, epochs_traced=2,
                 device=str(jax.devices()[0]))
    with open(os.path.join(trace_dir, "split.json"), "w") as f:
        json.dump(split, f, indent=1)
    with open(os.path.join(trace_dir, "module.hlo.txt"), "w") as f:
        f.write(hlo)
    print(json.dumps({k: v for k, v in split.items() if k != "ops_ns"}))
    return split


def run_ablate(batch, inner):
    """Attribution by subtraction on the speed config."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from deepfbsdejsolvers_tpu.models.merton import make_merton_default
    from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_tpu.solvers.train import make_adam, make_epoch_fn

    results = {}

    def measure(tag, solver_kw=None, model_kw=None, fwd_only=False,
                solver_cls=PricingSolver, unroll=None):
        model = make_merton_default(jump_sampler="icdf",
                                    price_mode="chebyshev",
                                    **(model_kw or {}))
        solver = solver_cls(
            model, "global",
            compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
            **(solver_kw or {}))
        params = solver.init_params(jax.random.key(0))
        optimizer = make_adam(4e-4)
        opt_state = optimizer.init(params)
        loss_fn = solver.build_loss(batch)
        if fwd_only:
            @jax.jit
            def epoch(params, opt_state, key):
                def step(c, k):
                    return c, loss_fn(params, k)
                _, losses = jax.lax.scan(step, 0.,
                                         jax.random.split(key, inner))
                return params, opt_state, losses[-1]
        else:
            epoch = make_epoch_fn(loss_fn, optimizer, inner)
        key = jax.random.key(1)
        med = timed(epoch, params, opt_state, key)
        n = model.N
        results[tag] = {"median_s": med,
                        "paths_steps_per_sec": batch * n * inner / med}
        print(f"{tag:34s} {med * 1e3:9.2f} ms  "
              f"{batch * n * inner / med:.3e} paths*steps/s", flush=True)

    measure("baseline_speed_config")
    measure("forward_only", fwd_only=True)
    measure("no_remat", solver_kw={"remat": False})
    # constant compensator: zero-out the x_interp sweep by collapsing the
    # Gamma net evaluation — approximated by 1-point "quadrature"
    measure("comp_1node",
            solver_kw={"compensator": CompensatorSpec(
                x_interp="chebyshev", n_cheb=64, n_poisson_max=1,
                n_hermite=1)})
    measure("comp_cheb16",
            solver_kw={"compensator": CompensatorSpec(
                x_interp="chebyshev", n_cheb=16)})
    measure("pricer_series_direct", model_kw={"price_mode": "series"})
    print(json.dumps(results, indent=1))
    return results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--mode", choices=["speed", "parity"], default="speed")
    p.add_argument("--model", choices=["merton", "vg", "mfg"],
                   default="merton",
                   help="workload to profile (--cost/--trace; --ablate is "
                        "merton-only)")
    p.add_argument("--compensator", choices=["quadrature", "mc"],
                   default="quadrature")
    p.add_argument("--cost", action="store_true")
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--trace", type=str, default=None)
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args()

    from deepfbsdejsolvers_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.cost:
        run_cost(args.batch, args.inner, args.mode, args.model,
                 args.compensator)
    if args.trace:
        run_trace(args.batch, args.inner, args.mode, args.trace, args.top,
                  args.model, args.compensator)
    if args.ablate:
        if args.model != "merton":
            p.error("--ablate supports only --model merton")
        run_ablate(args.batch, args.inner)


if __name__ == "__main__":
    main()
