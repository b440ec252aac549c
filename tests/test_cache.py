"""Compile-cache path rules (msm_tpu/utils/cache.py): JAX's own
JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed, gitignored
directory inside the checkout, whatever the working directory."""

import os

import jax
import pytest

from msm_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_wins_and_code_sets_no_other_dir(
    monkeypatch, tmp_path, restore_cache_config
):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    # what JAX itself does with the variable at start-up
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    assert not os.path.exists(os.path.join(str(tmp_path), "jax"))


def test_default_is_fixed_dir_inside_checkout(
    monkeypatch, tmp_path, restore_cache_config
):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)  # the cwd must not move the cache
    path = cache.enable_compilation_cache()
    assert path == os.path.join(ROOT, ".cache", "jax")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path


def test_default_dir_is_gitignored():
    rel = os.path.relpath(cache.default_cache_dir(), ROOT)
    top = rel.split(os.sep)[0] + "/"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert top in {line.strip() for line in f}
