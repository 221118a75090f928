"""The platform table, the compile-cache location, and the GPU-only entry
points' refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

from ft8_demodulator_tpu.utils import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the per-platform defaults the decoder ships with
EXPECTED = {
    ("FT8_SYNC_BACKEND", "cpu"): "stencil",
    ("FT8_SYNC_BACKEND", "gpu"): "mxu",
    ("FT8_MF_FRONT", "cpu"): "spectra",
    ("FT8_MF_FRONT", "gpu"): "spectra",
    ("FT8_DFT_PRECISION", "cpu"): "default",
    ("FT8_DFT_PRECISION", "gpu"): "bf16x3",
    ("FT8_OSD_GATE", "cpu"): "on",
    ("FT8_OSD_GATE", "gpu"): "on",
    ("FT8_OSD_ELIM", "cpu"): "jnp",
    ("FT8_OSD_ELIM", "gpu"): "triton",
}


@pytest.mark.parametrize("name,plat", sorted(EXPECTED))
def test_knob_platform_defaults(monkeypatch, name, plat):
    monkeypatch.setattr(backend, "platform", lambda: plat)
    monkeypatch.delenv(name, raising=False)
    assert backend.knob(name) == EXPECTED[name, plat]
    # an override wins on every platform; a typo raises
    other = next(v for v in backend.KNOBS[name][1]
                 if v != EXPECTED[name, plat])
    monkeypatch.setenv(name, f" {other.upper()} ")
    assert backend.knob(name) == other
    monkeypatch.setenv(name, other + "x")
    with pytest.raises(ValueError):
        backend.knob(name)


def test_unknown_platform_raises(monkeypatch):
    import jax

    assert backend.platform() == "cpu"
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        backend.platform()
    with pytest.raises(RuntimeError):
        backend.knob("FT8_SYNC_BACKEND")


def _cache_dir_in_child(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax; from ft8_demodulator_tpu.utils.cache import "
            "enable_compilation_cache as e; r = e(); "
            "print(r); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


@pytest.mark.parametrize("env_dir", [None, "elsewhere/cache"])
def test_compilation_cache_dir(env_dir):
    """JAX_COMPILATION_CACHE_DIR is honoured as set; otherwise the cache
    is the fixed .jax_cache/ at the repo root."""
    returned, in_config = _cache_dir_in_child(env_dir)
    want = env_dir or os.path.join(ROOT, ".jax_cache")
    assert returned == in_config == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
