"""chip_smoke.py's contract as far as the CPU can check it: it refuses to
run without a GPU, its last line has exactly the contract's keys, its
packed-bits phase passes, and the helpers it relies on behave."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("alone", [False, True])
def test_fails_without_gpu(tmp_path, alone):
    """On the CPU, in the checkout or alone in a directory, the script
    exits non-zero and prints no result."""
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_result_line_has_exactly_the_contract_keys():
    dev = jax.devices()[0]
    rec = json.loads(chip_smoke.result_line(dev, 1))
    assert rec == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": 1}}


def test_compile_cache_follows_env_else_checkout(monkeypatch):
    from light_loam_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        jax.config.update("jax_compilation_cache_dir", None)
        assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir is None  # left to JAX

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        want = str(REPO / ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_pallas_off_gpu_raises():
    """No library path falls back to interpret mode: the kernel, and the
    mapping stage with knn_backend="pallas", refuse a non-GPU platform."""
    import dataclasses

    from light_loam_tpu.config import HDL64_SMALL
    from light_loam_tpu.core import quaternion as quat
    from light_loam_tpu.core.frame import PointCloud
    from light_loam_tpu.models.mapping import MappingState, mapping_step
    from light_loam_tpu.ops.pallas_knn import knn_pallas

    q = jnp.zeros((8, 3))
    with pytest.raises(ValueError, match="'cpu'"):
        knn_pallas(q, q, jnp.ones(8, bool), k=5)

    mcfg = dataclasses.replace(HDL64_SMALL.mapping, knn_backend="pallas")
    pc = PointCloud.zeros(64)
    with pytest.raises(ValueError, match="'cpu'"):
        mapping_step(MappingState.init(mcfg), pc, pc, quat.quat_identity(),
                     jnp.zeros(3), mcfg)


def test_bits_phase_passes_on_cpu():
    chip_smoke.phase_bits()


def test_knn_check_flags_wrong_indices():
    """The kernel phase's float64 check is not vacuous."""
    rng = np.random.default_rng(0)
    q = rng.uniform(-30, 30, (64, 3)).astype(np.float32)
    r = rng.uniform(-30, 30, (512, 3)).astype(np.float32)
    m = np.ones(512, bool)
    d64, i64 = chip_smoke.knn_reference_f64(q, r, m, 5)
    err, bad, rows = chip_smoke.check_knn(d64[:, :5], i64[:, :5], q, r, m, 5)
    assert err == 0 and bad == 0 and rows > 50
    swapped = i64[:, [1, 0, 2, 3, 4]]
    _, bad, rows = chip_smoke.check_knn(d64[:, :5], swapped, q, r, m, 5)
    assert bad == rows
