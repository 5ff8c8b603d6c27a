#!/usr/bin/env python
"""Interleaved A/B of the mul_exp walk update vs plain x*exp(u).

``ops.numerics.mul_exp`` (a degree-7 Horner expm1 + select) replaces one
``exp`` in the innermost step of every pricing walk.  This script measures
what that arithmetic costs: SAME process, SAME warmed device, alternating
fresh builds of the shipped speed config with

  A: mul_exp(x, u)      (shipped exact walk arithmetic)
  B: x * jnp.exp(u)     (one transcendental, the variant a biased exp skews)

interleaved A B A B ... so drift affects both arms equally.  ``mul_exp``
is bound at trace time (models/merton.py ``step`` imports it per call),
so monkeypatching ``numerics.mul_exp`` before each loss build switches
the traced arithmetic; the B arm is verified switched by comparing one
forward loss value between arms (they differ in the 6th decimal).

Usage:
  python scripts/mul_exp_ab.py [--batch 131072] [--inner 10] [--reps 4]
                               [--model merton|vg] [--degree 7]
  --degree N additionally measures a degree-N Taylor arm (A5 etc.) to
  size a cheaper polynomial if the tax is real.
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def build_epoch(batch, inner, model_name):
    from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_tpu.solvers.train import make_adam, make_epoch_fn

    if model_name == "vg":
        import dataclasses

        from deepfbsdejsolvers_tpu.models.variance_gamma import make_vg_default

        model = dataclasses.replace(make_vg_default(jump_sampler="icdf"),
                                    price_eval="chebyshev")
        solver = PricingSolver(
            model, "global",
            compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
            hoist=True, hoist_interp="piecewise", scan_chunk=2)
    else:
        from deepfbsdejsolvers_tpu.models.merton import make_merton_default

        model = make_merton_default(jump_sampler="icdf",
                                    price_mode="chebyshev")
        solver = PricingSolver(
            model, "global",
            compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
            hoist=True, hoist_interp="piecewise", scan_chunk=2)
    params = solver.init_params(jax.random.key(0))
    optimizer = make_adam(4e-4)
    opt_state = optimizer.init(params)
    loss_fn = solver.build_loss(batch)
    epoch = make_epoch_fn(loss_fn, optimizer, inner)
    return model, epoch, params, optimizer.init(params)


def measure_arm(batch, inner, model_name, rounds=5):
    """Fresh build + warmup + ``rounds`` timed epochs; returns (median rate,
    times, one loss value for the arm-switch check)."""
    model, epoch, params, opt_state = build_epoch(batch, inner, model_name)
    key = jax.random.key(1)
    for w in range(2):
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, 1000 + w))
        jax.block_until_ready(loss)
    check_loss = float(loss)
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    return batch * model.N * inner / med, times, check_loss


def taylor_expm1(degree):
    def expm1_deg(u):
        p = u / float(degree)
        for k in range(degree - 1, 1, -1):
            p = (1.0 + p) * u / float(k)
        return jnp.where(jnp.abs(u) < 0.125, u * (1.0 + p), jnp.exp(u) - 1.0)
    return expm1_deg


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--model", choices=["merton", "vg"], default="merton")
    p.add_argument("--degree", type=int, default=0,
                   help="also measure a degree-N Taylor arm (0 = off)")
    args = p.parse_args()

    from deepfbsdejsolvers_tpu.ops import numerics

    shipped_mul_exp = numerics.mul_exp

    def plain_mul_exp(x, u):
        return x * jnp.exp(u)

    arms = {"A_mul_exp": shipped_mul_exp, "B_plain_exp": plain_mul_exp}
    if args.degree:
        e = taylor_expm1(args.degree)
        arms[f"C_taylor{args.degree}"] = lambda x, u: x + x * e(u)

    results = {name: [] for name in arms}
    losses = {}
    for rep in range(args.reps):
        for name, fn in arms.items():
            numerics.mul_exp = fn
            try:
                rate, times, loss = measure_arm(args.batch, args.inner,
                                                args.model)
            finally:
                numerics.mul_exp = shipped_mul_exp
            results[name].append(rate)
            losses.setdefault(name, loss)
            print(f"rep={rep} {name:<12s} {rate:.4e}  "
                  f"times_ms={[f'{t*1e3:.1f}' for t in times]}", flush=True)

    print("\n== summary ==")
    for name, vals in results.items():
        med = statistics.median(vals)
        print(f"{name:<12s} median {med:.4e}  min {min(vals):.3e}  "
              f"max {max(vals):.3e}  loss@warmup {losses[name]:.8f}")
    a = statistics.median(results["A_mul_exp"])
    b = statistics.median(results["B_plain_exp"])
    print(f"mul_exp tax: {(b - a) / b * 100:+.2f}% "
          f"(positive = mul_exp slower)")
    if abs(losses["A_mul_exp"] - losses["B_plain_exp"]) == 0.0:
        print("WARNING: arm losses identical — the monkeypatch may not have "
              "switched the traced arithmetic", file=sys.stderr)


if __name__ == "__main__":
    main()
