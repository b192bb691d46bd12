"""The compile-cache policy shared by the CLI, bench.py, chip_smoke.py
and the tests (spydrpick_jax/utils/jax_cache.py)."""

import os

import pytest

from spydrpick_jax.utils import jax_cache as jc


@pytest.mark.parametrize(
    "override,environ,want",
    [
        (None, {}, jc.CHECKOUT_CACHE_DIR),
        (None, {"JAX_COMPILATION_CACHE_DIR": "/env/cache"}, "/env/cache"),
        ("/explicit", {"JAX_COMPILATION_CACHE_DIR": "/env/cache"}, "/explicit"),
        ("none", {"JAX_COMPILATION_CACHE_DIR": "/env/cache"}, None),
    ],
    ids=["checkout", "env", "override", "none"],
)
def test_resolve_cache_dir(override, environ, want):
    assert jc.resolve_cache_dir(override, environ) == want


def test_checkout_cache_dir_is_fixed_inside_the_checkout():
    """One fixed path at the checkout root, listed in .gitignore."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jc.CHECKOUT_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_cache_dir_is_left_to_jax(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, no other directory is set in
    code; an explicit override still wins."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/env/cache")
    assert jc.configure_compile_cache() == "/env/cache"
    assert all(k != "jax_compilation_cache_dir" for k, _ in calls)
    calls.clear()
    assert jc.configure_compile_cache("/explicit") == "/explicit"
    assert ("jax_compilation_cache_dir", "/explicit") in calls
    calls.clear()
    assert jc.configure_compile_cache("none") is None and not calls
    assert jax.config.jax_compilation_cache_dir == before
