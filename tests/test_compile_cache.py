"""The CLI device backends persist compiles across processes (the
reference binary has zero warm-up) in ONE cache: JAX_COMPILATION_CACHE_DIR
when set, else the fixed directory <checkout>/.jax_cache."""

import os

import jax
import pytest

from lzani.runtime import DEFAULT_CACHE_DIR, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_configured(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    loc = enable_compile_cache()
    assert loc == DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == loc


def test_cache_disable(tmp_path, monkeypatch, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the function uses it and sets
    nothing in code."""
    loc = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", loc)
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == loc
    assert jax.config.jax_compilation_cache_dir == before
