"""Process set-up shared by every entry point: JAX's persistent
compilation cache and the XLA flags the device engine runs with."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")

# The automaton is nested while loops of small kernels. With WHILE and
# CONDITIONAL in XLA's GPU command buffers, a loop's predicate is decided
# on the card instead of being copied to the host every iteration (2-2.4x
# on the automaton on an H100; PERF.md). The CPU backend accepts and
# ignores the flag.
GPU_XLA_FLAGS = ("--xla_gpu_enable_command_buffer=+WHILE,+CONDITIONAL",)


def enable_compile_cache() -> str:
    """Persist compiled programs across processes and return the cache
    directory. JAX_COMPILATION_CACHE_DIR, when set, is used as it stands
    (JAX reads it itself, and nothing is set here); otherwise the cache is
    the fixed directory .jax_cache at the root of the checkout."""
    loc = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if loc:
        return loc
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def set_xla_flags() -> str:
    """Add GPU_XLA_FLAGS to XLA_FLAGS, except a flag the environment
    already sets. XLA reads XLA_FLAGS when JAX starts its first backend,
    so this runs before anything touches a device. Returns XLA_FLAGS."""
    flags = os.environ.get("XLA_FLAGS", "")
    for f in GPU_XLA_FLAGS:
        if f.split("=")[0] not in flags:
            flags = f"{flags} {f}".strip()
    os.environ["XLA_FLAGS"] = flags
    return flags
