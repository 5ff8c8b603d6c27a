#!/usr/bin/env python
"""Absolute roofline for the headline train step on the GPU in hand.

1. MEASURE the device's ceilings (next to the published peaks of
   ``bench.PEAKS``: a card below its full power limit, or any real kernel,
   reaches less).  Each ceiling is a dependent in-jit op chain timed at two
   chain lengths; the marginal time per link cancels dispatch and sync
   overhead:
     * device-memory bandwidth: big-array copy (2 streams) and triad (3);
     * FP32 FMA rate outside the tensor cores: a 512-deep unrolled FMA
       chain on an 8 MiB working set (cache-resident, compute-bound);
     * matmul rate: chained 8192^3 products in bf16, in f32 at DEFAULT
       precision (TF32 tensor cores) and in f32 at HIGHEST.
2. Account the headline step (bench.py speed config, 2^17 batch):
     * XLA's own compiled-HLO cost analysis (flops, bytes accessed);
     * an analytic per-step memory-traffic floor from first principles
       (pre-drawn noise reads + scan-carry and saved-residual traffic).
3. Report: measured step time vs bytes/bandwidth (bandwidth-bound fraction)
   and vs flops/FP32-rate (compute-bound fraction).

The workload is far from matmul-bound by construction (tiny MLP heads +
elementwise SDE math): the honest headroom statement is the bandwidth
utilization, printed last.

Usage: python scripts/roofline.py [--batch 131072] [--skip-ceilings]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _time_scalar(fn, *args, reps=5):
    """Median wall time of a jitted fn that RETURNS A SCALAR, synced by
    fetching the scalar to the host."""
    float(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _marginal_chain_time(make_chain, k_lo=4, k_hi=16, reps=5):
    """Per-link time of a dependent in-jit op chain, from the marginal
    (t(k_hi) - t(k_lo)) / (k_hi - k_lo) — cancels the fixed dispatch and
    fetch overhead a single-call timing includes."""
    t_lo = _time_scalar(make_chain(k_lo), reps=reps)
    t_hi = _time_scalar(make_chain(k_hi), reps=reps)
    return (t_hi - t_lo) / (k_hi - k_lo)


def measure_hbm_bw():
    n = 1 << 28  # 1 GiB f32, far above the 50 MB L2
    x = jnp.arange(n, dtype=jnp.float32) * 1e-9

    def make_copy(k):
        @jax.jit
        def chain(x):
            def body(c, _):
                return c + 1.0, None       # read 4n + write 4n bytes
            c, _ = jax.lax.scan(body, x, None, length=k)
            return c[0]
        return lambda: chain(x)

    t = _marginal_chain_time(make_copy)
    copy_bw = 8.0 * n / t

    y = jnp.ones((n,), jnp.float32)

    def make_triad(k):
        @jax.jit
        def chain(x, y):
            def body(c, _):
                return c + 2.0 * y, None   # read 8n + write 4n bytes
            c, _ = jax.lax.scan(body, x, None, length=k)
            return c[0]
        return lambda: chain(x, y)

    t = _marginal_chain_time(make_triad)
    triad_bw = 12.0 * n / t
    return copy_bw, triad_bw


def measure_fma_f32():
    # 8 MiB working set (cache-resident), 512 serial FMAs per element per
    # chain link: intensity ~512 FLOP/byte, compute-bound.
    n = 1 << 21
    x = jnp.linspace(0.1, 0.9, n, dtype=jnp.float32)
    iters = 512

    def make_chain(k):
        @jax.jit
        def chain(x):
            def body(c, _):
                return c * 1.000001 + 3e-7, None
            c, _ = jax.lax.scan(body, x, None, length=k * iters, unroll=64)
            return c[0]
        return lambda: chain(x)

    t = _marginal_chain_time(make_chain, k_lo=1, k_hi=4)
    return 2.0 * n * iters / t


def measure_matmul(dtype, precision=None):
    m = 8192
    key = jax.random.key(0)
    a = (jax.random.normal(key, (m, m)) / np.sqrt(m)).astype(dtype)

    def make_chain(k):
        @jax.jit
        def chain(a):
            def body(c, _):
                # dependent matmul chain; rescale to keep values bounded
                c = jnp.dot(c, a, precision=precision,
                            preferred_element_type=jnp.float32)
                return (c / jnp.float32(m)).astype(dtype), None
            c, _ = jax.lax.scan(body, a, None, length=k)
            return c[0, 0].astype(jnp.float32)
        return lambda: chain(a)

    t = _marginal_chain_time(make_chain, k_lo=2, k_hi=8)
    return 2.0 * m**3 / t


def headline_cost(batch):
    import bench

    from deepfbsdejsolvers_tpu.solvers.train import make_epoch_fn

    model, solver, params, optimizer, opt_state, loss_fn = bench.build(
        batch, "quadrature", parity=False, model_name="merton")
    inner = 1  # per-train-step accounting
    epoch = make_epoch_fn(loss_fn, optimizer, inner)
    key = jax.random.key(1)
    lowered = jax.jit(
        lambda p, o, k: epoch(p, o, k)).lower(params, opt_state, key)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca.get("flops", float("nan")))
    bytes_accessed = float(ca.get("bytes accessed", float("nan")))
    # measured per-train-step time at inner=10 (amortizes dispatch)
    epoch10 = make_epoch_fn(loss_fn, optimizer, 10)
    for w in range(2):
        params, opt_state, loss = epoch10(params, opt_state,
                                          jax.random.fold_in(key, 1000 + w))
        float(loss)
    times = []
    for r in range(5):
        t0 = time.perf_counter()
        params, opt_state, loss = epoch10(params, opt_state,
                                          jax.random.fold_in(key, r))
        float(loss)
        times.append(time.perf_counter() - t0)
    step_time = sorted(times)[len(times) // 2] / 10.0
    return flops, bytes_accessed, step_time, model


def analytic_floor_bytes(batch, model):
    """First-principles device-memory floor per train step (forward +
    backward).

    Per-step per-path f32 items that MUST cross device memory at 2^17
    batch (the path-sized state of 50 steps does not stay on chip):
      forward: pre-drawn noise reads (dW, U_poisson, Z_jump = 3 reads),
      scan xs for hoisted price/compensator piecewise tables are
      coefficient-sized (negligible); saved residuals for backward under
      remat: the carry X per chunk boundary (scan_chunk=2 -> N/2
      checkpoints) + the same noise re-read in the backward sweep.
    Floor = fwd reads (3) + ckpt writes (0.5) + bwd re-reads (3 + 0.5)
          = 7 f32 streams per path-step.
    """
    n_streams = 7.0
    return 4.0 * n_streams * batch * model.N


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2**17)
    p.add_argument("--skip-ceilings", action="store_true")
    args = p.parse_args()

    from bench import peaks_for
    from deepfbsdejsolvers_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    peaks = peaks_for(dev.device_kind)
    out = {"device": str(dev), "device_kind": dev.device_kind,
           "published_peaks": peaks}
    if not args.skip_ceilings:
        copy_bw, triad_bw = measure_hbm_bw()
        out["hbm_copy_GBps"] = copy_bw / 1e9
        out["hbm_triad_GBps"] = triad_bw / 1e9
        out["fma_f32_TFLOPs"] = measure_fma_f32() / 1e12
        out["matmul_bf16_TFLOPs"] = measure_matmul(jnp.bfloat16) / 1e12
        out["matmul_tf32_TFLOPs"] = measure_matmul(
            jnp.float32, jax.lax.Precision.DEFAULT) / 1e12
        out["matmul_f32_TFLOPs"] = measure_matmul(
            jnp.float32, jax.lax.Precision.HIGHEST) / 1e12
        print(json.dumps(out), flush=True)

    flops, bytes_accessed, step_time, model = headline_cost(args.batch)
    out["headline_flops_per_step"] = flops
    out["headline_bytes_accessed_per_step"] = bytes_accessed
    out["headline_step_seconds"] = step_time
    out["headline_paths_steps_per_sec"] = args.batch * model.N / step_time
    out["analytic_floor_bytes_per_step"] = analytic_floor_bytes(args.batch,
                                                                model)
    bw = out.get("hbm_triad_GBps", 0) * 1e9
    if bw:
        out["t_bw_xla_bytes_s"] = bytes_accessed / bw
        out["t_bw_floor_s"] = out["analytic_floor_bytes_per_step"] / bw
        out["bw_utilization_xla_bytes"] = out["t_bw_xla_bytes_s"] / step_time
        out["bw_utilization_floor"] = out["t_bw_floor_s"] / step_time
        fma = out.get("fma_f32_TFLOPs", 0) * 1e12
        if fma:
            out["t_fma_s"] = flops / fma
            out["fma_utilization"] = out["t_fma_s"] / step_time
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
