"""The main path imports only the packages every host has, and the
compile cache and the on-card smoke check behave as documented."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

BLOCK = """
import sys
for m in ("flax", "orbax", "orbax.checkpoint", "pyarrow", "pandas", "torch"):
    sys.modules[m] = None   # any import of these now raises ImportError
sys.path.insert(0, {repo!r})
import intentbev.train, intentbev.evaluate, intentbev.parallel
import intentbev.checkpoint, intentbev.import_torch
import bench, chip_smoke
print("ok")
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_main_path_imports_without_optional_packages():
    r = subprocess.run([sys.executable, "-c", BLOCK.format(repo=str(REPO))],
                       capture_output=True, text=True, env=_env(), cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_gpu():
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=_env(), cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=_env(PYTHONPATH=""), cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        from intentbev.utils import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.cache_dir() == str(tmp_path)

    def test_default_is_fixed_inside_checkout(self, monkeypatch):
        from intentbev.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = Path(compile_cache.cache_dir())
        assert d == REPO / ".jax_cache"
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()

    def test_programs_land_in_env_dir(self, tmp_path):
        code = (
            "import sys; sys.path.insert(0, %r)\n"
            "import jax, jax.numpy as jnp\n"
            "from intentbev.utils.compile_cache import enable_compilation_cache\n"
            "enable_compilation_cache()\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
            "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
            % str(REPO))
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           env=_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)), timeout=300)
        assert r.returncode == 0, r.stderr
        assert any(tmp_path.iterdir())

    @pytest.mark.parametrize("set_env", [True, False])
    def test_enable_sets_no_other_directory(self, tmp_path, set_env):
        """With the env var set, JAX's own setting is the only cache
        directory; without it, the checkout default is configured."""
        code = (
            "import sys; sys.path.insert(0, %r)\n"
            "import jax\n"
            "from intentbev.utils.compile_cache import enable_compilation_cache\n"
            "enable_compilation_cache()\n"
            "print(jax.config.jax_compilation_cache_dir)\n" % str(REPO))
        extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if set_env else {}
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=_env(**extra), timeout=300)
        assert r.returncode == 0, r.stderr
        want = str(tmp_path) if set_env else str(REPO / ".jax_cache")
        assert r.stdout.strip().splitlines()[-1] == want
