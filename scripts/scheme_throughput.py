#!/usr/bin/env python
"""Record throughput for ALL seven pricing schemes x {parity, speed}.

Every recorded perf number before round 5 was the global scheme; the
other six (multistep1/2, sumlocal1/2, sumlocal_reg, multistep_reg —
SolversJumpDiff.py:75-513) share the hoisted machinery (equality-tested
in tests/test_fast_paths.py) but had no recorded throughput, leaving the
reference's method sweep (mainMerton.py:79-118) 6/7 unprofiled here.
This script produces the one table, reusing
bench.py's builders so the configs are exactly the shipped ones.

Usage:
  python scripts/scheme_throughput.py [--batch 131072] [--inner 10]
      [--modes speed,parity] [--schemes all] [--model merton]
Emits one JSON line per cell plus a final markdown table on stderr.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

SCHEMES = ("global", "multistep1", "multistep2", "sumlocal1", "sumlocal2",
           "sumlocal_reg", "multistep_reg")


def measure_cell(batch, inner, scheme, parity, model_name, rounds=3):
    import bench

    from deepfbsdejsolvers_tpu.solvers.train import make_epoch_fn

    model, solver, params, optimizer, opt_state, loss_fn = bench.build(
        batch, "quadrature", parity, model_name, scheme=scheme)
    epoch = make_epoch_fn(loss_fn, optimizer, inner)
    key = jax.random.key(1)
    for w in range(2):
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, 1000 + w))
        jax.block_until_ready(loss)
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch(params, opt_state,
                                        jax.random.fold_in(key, r))
        jax.block_until_ready(loss)
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    return batch * model.N * inner / med, times


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--modes", default="speed,parity")
    p.add_argument("--schemes", default="all")
    p.add_argument("--model", choices=["merton", "vg"], default="merton")
    args = p.parse_args()

    schemes = SCHEMES if args.schemes == "all" else args.schemes.split(",")
    modes = args.modes.split(",")
    table = {}
    for scheme in schemes:
        for mode in modes:
            try:
                rate, times = measure_cell(args.batch, args.inner, scheme,
                                           mode == "parity", args.model)
                table[(scheme, mode)] = rate
                print(json.dumps({"model": args.model, "scheme": scheme,
                                  "mode": mode, "paths_steps_per_sec": rate,
                                  "round_seconds": times}), flush=True)
            except Exception as e:
                table[(scheme, mode)] = None
                print(json.dumps({"model": args.model, "scheme": scheme,
                                  "mode": mode,
                                  "error": f"{type(e).__name__}: {e}"[:300]}),
                      flush=True)

    print(f"\n| scheme | " + " | ".join(modes) + " |", file=sys.stderr)
    print("|---" * (len(modes) + 1) + "|", file=sys.stderr)
    for scheme in schemes:
        cells = " | ".join(
            f"{table[(scheme, m)]:.2e}" if table[(scheme, m)] else "FAIL"
            for m in modes)
        print(f"| {scheme} | {cells} |", file=sys.stderr)


if __name__ == "__main__":
    main()
