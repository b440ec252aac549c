"""Persistent XLA compilation cache setup.

A 512^3 interval program takes tens of seconds to compile; the persistent
cache makes that a one-time cost per (program, shape, flags) across
processes. On by default in the CLI and bench entry points:

- `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself and this module
  sets no other directory.
- otherwise: a fixed directory inside the checkout, `<repo>/.cache/jax`
  (listed in `.gitignore`), so every run of one checkout finds the
  programs the earlier runs compiled.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`<repo>/.cache/jax`: the checkout-local cache used when
    `JAX_COMPILATION_CACHE_DIR` is unset."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, ".cache", "jax")


def enable_compilation_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    if os.environ.get(ENV_VAR):
        return jax.config.jax_compilation_cache_dir
    path = default_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
