"""The backend choice, the compile-cache placement and chip_smoke.py's
refusal to report without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

import superman_tpu as sp
from superman_tpu import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,configured,want", [
    ("gpu", "", "gpu"),
    ("cuda", "cuda", "gpu"),
    ("cpu", "cpu", "cpu"),
    ("cpu", "", "raise"),
    ("tpu", "", "raise"),
    ("tpu", "tpu", "raise"),
])
def test_backend_choice(monkeypatch, platform, configured, want):
    """GPU -> "gpu"; CPU only when it was explicitly requested; anything
    else raises instead of falling back to the interpreter."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(backend, "_cpu_requested",
                        lambda: configured == "cpu")
    if want == "raise":
        with pytest.raises(RuntimeError):
            backend.backend()
    else:
        assert backend.backend() == want
        assert backend.interpret() == (want == "cpu")


def test_results_record_backend(rng):
    a = rng.integers(0, 3, (6, 6))
    assert sp.permanent(a).meta["backend"] == "cpu"
    assert all(r.meta["backend"] == "cpu"
               for r in sp.permanent_batch([a, a + 1]))


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_placement(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise .jax_cache/ inside the
    checkout (never the home directory)."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert sp._cache_dir() == os.path.join(ROOT, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert sp._cache_dir() == str(tmp_path)


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke check exits non-zero and never prints
    its ok line."""
    p = _smoke(ROOT, "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "no GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository it fails too (nothing to import)."""
    src = os.path.join(ROOT, "chip_smoke.py")
    with open(src) as f, open(tmp_path / "chip_smoke.py", "w") as g:
        g.write(f.read())
    p = _smoke(str(tmp_path), "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
