"""The backend policy module (what each platform gets for every 'auto'
option), the compile-cache placement, and chip_smoke.py's refusal to
run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

from orbitanalysis_tpu import policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("id_dtype,angle_dtype,particles_axis,want", [
    (np.int32, np.float32, False, "general"),
    (np.int64, np.float32, False, "aligned"),   # no x64 needed
    (np.int64, np.float16, False, "general"),   # aligned packs f32 angles
    (np.int64, np.float32, True, "general"),    # aligned shards halos only
    (np.uint64, np.float32, False, "general"),
])
def test_join_engine(id_dtype, angle_dtype, particles_axis, want):
    assert policy.join_engine(id_dtype, angle_dtype,
                              particles_axis=particles_axis) == want


def test_tracker_auto_wide_ids_take_aligned_engine(tmp_path):
    """track_orbits(join_impl='auto', id_dtype=int64) runs without x64:
    the policy sends it to the aligned engine's position surrogate."""
    import h5py
    import jax

    from helpers import make_callbacks
    from orbitanalysis_tpu import track_orbits
    from orbitanalysis_tpu.models.synthetic import churn_snapshots
    from orbitanalysis_tpu.utils.metrics import Metrics

    assert not jax.config.jax_enable_x64
    snaps, centers = churn_snapshots(2, 80, 4, box_size=50.0, seed=5)
    shift = np.int64(2) ** 33
    for s in snaps:
        for h in s:
            s[h]["ids"] = s[h]["ids"].astype(np.int64) + shift
    regions, loader = make_callbacks(snaps, centers, box_size=50.0)
    save = str(tmp_path / "wide.h5")
    track_orbits(np.arange(4), np.tile(np.arange(2), (4, 1)), regions,
                 loader, save, id_dtype=np.int64, metrics=Metrics(),
                 verbose=False)
    with h5py.File(save) as hf:
        ids = np.concatenate([hf[k]["pericenter_IDs"][:] for k in hf])
    assert ids.dtype == np.int64
    assert (ids >= shift).all()


def test_interpolation_and_frames_choices():
    assert policy.interpolation(256) == "scalar"
    assert policy.interpolation(512) == "scalar"
    assert policy.label_frames(64, plat="gpu") == "gather"
    assert policy.label_frames(1536, plat="gpu") == "gather"
    assert policy.label_frames(64, plat="cpu") == "matmul"
    assert policy.label_frames(policy.TWOLEVEL_MIN_H, plat="cpu") == (
        "twolevel")


def test_direct_force_and_cache_choices():
    assert policy.direct_force_impl("gpu") == "triton"
    assert policy.direct_force_impl("cpu") == "xla"
    assert policy.compile_cache_enabled("gpu")
    assert not policy.compile_cache_enabled("cpu")
    assert policy.platform() == "cpu"  # the CPU test tier


def _enable_with(monkeypatch, env_dir):
    """Run enable_compilation_cache as the GPU would, recording the
    config updates instead of applying them."""
    import jax

    from orbitanalysis_tpu.utils import cache

    updates = {}
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.setattr(policy, "compile_cache_enabled", lambda: True)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    return cache.enable_compilation_cache(), updates


def test_cache_placement_from_environment(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program uses it and sets
    no cache directory in code."""
    path, updates = _enable_with(monkeypatch, str(tmp_path / "jc"))
    assert path == str(tmp_path / "jc")
    assert "jax_compilation_cache_dir" not in updates
    assert updates["jax_enable_compilation_cache"] is True


def test_cache_placement_fixed_in_checkout(monkeypatch):
    """Without the variable the cache lives at one fixed path inside the
    checkout (listed in .gitignore), never a temporary one."""
    from orbitanalysis_tpu.utils import cache

    path, updates = _enable_with(monkeypatch, None)
    assert path == cache.DEFAULT_DIR
    assert updates["jax_compilation_cache_dir"] == cache.DEFAULT_DIR
    assert os.path.dirname(cache.DEFAULT_DIR) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert os.path.basename(cache.DEFAULT_DIR) + "/" in f.read().split()


def test_cache_stays_off_on_cpu():
    from orbitanalysis_tpu.utils.cache import enable_compilation_cache

    assert enable_compilation_cache() is None


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero, with no 'ok' line, without a GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
