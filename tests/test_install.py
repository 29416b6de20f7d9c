"""What an installation needs: the compile cache's location, the user
cache path, and imports that stay within jax, numpy and scipy."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import audian_tpu

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def config_calls(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(audian_tpu, "_cache_enabled", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda key, val: calls.append((key, val)))
    return calls


def test_compilation_cache_honours_env(config_calls, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the program
    sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    audian_tpu.enable_compilation_cache()
    assert [k for k, _v in config_calls] == [
        "jax_persistent_cache_min_compile_time_secs"]


def test_compilation_cache_default_in_checkout(config_calls, monkeypatch):
    """Unset, the cache lives in a fixed directory inside the checkout
    (listed in .gitignore)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    audian_tpu.enable_compilation_cache()
    assert ("jax_compilation_cache_dir", str(REPO / ".jax_cache")) \
        in config_calls
    assert (REPO / ".jax_cache").is_dir()
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_user_cache_path_follows_xdg(monkeypatch, tmp_path):
    from audian_tpu.version import audian_dirs

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert audian_dirs.user_cache_path == tmp_path / "audian-tpu"
    monkeypatch.delenv("XDG_CACHE_HOME")
    assert audian_dirs.user_cache_path == \
        Path.home() / ".cache" / "audian-tpu"


def test_entry_points_import_without_optional_packages():
    """The CLIs, the browser and Data import with platformdirs and pandas
    unavailable (a None entry in sys.modules makes an import fail)."""
    code = ("import sys\n"
            "sys.modules['platformdirs'] = None\n"
            "sys.modules['pandas'] = None\n"
            "import audian_tpu.app, audian_tpu.cli.songdetector\n"
            "import audian_tpu.cli.audian, audian_tpu.cli.compress\n"
            "from audian_tpu.data import Data\n"
            "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"
