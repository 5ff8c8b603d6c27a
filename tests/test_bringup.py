"""CPU tests of the GPU bring-up tooling: chip_smoke's device refusal and
result line, the compile-cache location, the dry run's mesh label, and the
device-trace reduction of utils/profiling."""

import glob
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import pytest

from deepfbsdejsolvers_tpu.utils import compile_cache
from deepfbsdejsolvers_tpu.utils.profiling import (
    device_time_split, scope_weights, union_ns)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    return _load("chip_smoke", REPO / "chip_smoke.py")


def _fake_gpu():
    return types.SimpleNamespace(platform="gpu",
                                 device_kind="NVIDIA H100 80GB HBM3")


# ------------------------------------------------------------ chip_smoke
def test_require_gpu_refuses_cpu(cs):
    with pytest.raises(SystemExit) as e:
        cs.require_gpu(jax.devices())
    assert "needs a GPU" in str(e.value.code)
    cs.require_gpu([_fake_gpu()])          # a GPU passes


def test_main_refuses_cpu_and_prints_no_result(cs, capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_is_the_contract(cs, count):
    line = cs.result_line([_fake_gpu()] * count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_card_line_without_nvidia_smi(cs, monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert cs.card_line().startswith("nvidia-smi unavailable")


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo: the
    script exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# --------------------------------------------------------- compile cache
def test_compile_cache_env_var_is_used():
    assert compile_cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/c"}) == (
        "/x/c", True)


def test_compile_cache_default_is_fixed_inside_repo():
    path, from_env = compile_cache.cache_dir({})
    assert not from_env
    assert path == str(REPO / ".jax_cache")
    assert compile_cache.cache_dir({}) == (path, False)   # no pid, no time


def test_compile_cache_default_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_enable_compile_cache_sets_nothing_when_env_set(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x/c")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/x/c"
    assert jax.config.jax_compilation_cache_dir == before


# ------------------------------------------------------------ dry run
def test_dryrun_label_names_virtual_cpu_mesh():
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as ge

    label = ge.mesh_label(jax.devices()[:4])
    assert "virtual CPU mesh" in label and "4" in label
    gpu_label = ge.mesh_label([_fake_gpu()] * 4)
    assert "virtual" not in gpu_label and "H100" in gpu_label


# ------------------------------------------------------------ profiling
def _scoped(x):
    with jax.named_scope("comp_sweep"):
        y = jnp.tanh(x @ x)
    return jnp.sum(2.0 * y)


def test_scope_weights_attribute_named_scope():
    txt = jax.jit(_scoped).lower(jnp.ones((32, 32))).compile().as_text()
    w = scope_weights(txt, "comp_sweep")
    assert max(w.values()) == 1.0          # the dot inside the scope
    assert scope_weights(txt, "no_such_scope") == {k: 0.0 for k in w}


def test_union_ns():
    assert union_ns([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert union_ns([]) == 0.0


def test_device_time_split_on_cpu_trace(tmp_path):
    f = jax.jit(_scoped)
    x = jnp.ones((128, 128))
    weights = scope_weights(f.lower(x).compile().as_text(), "comp_sweep")
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    for _ in range(3):
        f(x).block_until_ready()
    jax.profiler.stop_trace()
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    split = device_time_split(path, weights, plane_prefix="/host:CPU")
    assert split["events_matched_to_hlo"] > 0
    assert 0.0 < split["scope_share_of_kernel_time"] <= 1.0
    assert split["busy_ns"] <= split["window_ns"]
    with pytest.raises(ValueError):
        device_time_split(path, weights)      # no /device: plane on CPU
