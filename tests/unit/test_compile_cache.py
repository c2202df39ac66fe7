"""The persistent compile cache helper (faucet_tpu/compile_cache.py)."""
import os

import jax

from faucet_tpu import compile_cache as CC

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_env_var_wins(monkeypatch, tmp_path):
    want = str(tmp_path / "cache")
    assert CC.cache_dir({CC.ENV: want}) == want
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(CC.ENV, want)
    assert CC.enable_compile_cache() == want
    # JAX reads the variable itself: the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv(CC.ENV, raising=False)
    path = CC.cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    assert CC.cache_dir({CC.ENV: ""}) == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    before = jax.config.jax_compilation_cache_dir
    try:
        assert CC.enable_compile_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
