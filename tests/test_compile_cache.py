"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
else one fixed directory inside the checkout."""

import os

import jax
import pytest

from vcf_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_used_and_nothing_is_set(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/somewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert first == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    assert compile_cache.enable_compile_cache() == first  # no tmp/pid/time


def test_default_dir_is_git_ignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
