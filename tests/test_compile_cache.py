"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR, or else
the fixed directory inside the checkout."""
import os

import jax
import pytest

from norlab_icp_mapper_tpu.utils import compile_cache
from norlab_icp_mapper_tpu.utils.compile_cache import (CACHE_DIR,
                                                       enable_compile_cache)


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_wins(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_inside_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(compile_cache.__file__))))
    assert CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
