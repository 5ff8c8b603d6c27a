"""Full convergence gates — deselected by default (pyproject addopts
``-m 'not slow and not device'``).  Run explicitly on the accelerator, in
ONE process (no xdist: each worker would reserve most of the card's
memory), with::

    FBSDEJ_DEVICE_TESTS=1 python -m pytest tests/test_convergence_slow.py \
        -m slow --no-header -q -p no:xdist

or reproduce the same matrix standalone via scripts/convergence_gates.py.
``FBSDEJ_DEVICE_TESTS=1`` keeps the real device visible (conftest.py
otherwise forces the virtual CPU mesh, where each gate takes tens of
minutes).
"""

import pytest

pytestmark = pytest.mark.slow


def _run(gate):
    import sys

    sys.path.insert(0, ".")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "convergence_gates", "scripts/convergence_gates.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # registry lives inside main(); rebuild the one gate directly
    from deepfbsdejsolvers_tpu.models.merton import make_merton_default
    from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec

    merton_oracle = make_merton_default().price_at_origin()
    cheb64 = CompensatorSpec(x_interp="chebyshev", n_cheb=64)
    if gate == "merton_speed":
        # Robust (3-seed) uncoupled Global gate with warm Y0 start — the
        # round-2 study protocol (5/5 seeds <= 2.2e-4).  The coupled
        # aLin=0.1 configs have an inherent ±(1-3.5)e-3 scheme deviation at
        # any budget (round-2 floor analysis) and are
        # diagnostics, not hard gates.
        return mod.run_gate(
            "merton_speed",
            make_merton_default(a_lin=0.0, jump_sampler="icdf",
                                price_mode="chebyshev"),
            merton_oracle, "global", compensator=cheb64, seeds=3,
            peak_lr=3e-3, steps=2400, warm_y0=True)
    raise ValueError(gate)


def test_merton_speed_gate():
    record = _run("merton_speed")
    assert record["abs_error"] <= 1e-3


def test_vg_global_uncoupled_gate():
    """VG Global (uncoupled) passes the 1e-3 gate vs the FFT oracle — 5/5
    seeds in the round-2 study; this re-runs seed 0."""
    import sys

    sys.path.insert(0, ".")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gate_vg_study", "scripts/gate_vg_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    y0, err, oracle = mod.run_once(0, a_lin=0.0)
    assert err <= 1e-3, (y0, oracle)
