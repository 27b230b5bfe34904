"""burst_tpu: optimal short-read DNA aligner on an accelerator.

A from-scratch re-design of the capabilities of knights-lab/BURST for
accelerator hardware: bit-parallel Myers scan kernels over a sharded
reference database, exact tie-aware rescoring, and BURST-compatible
databases, modes, and blast6 output.
"""
import os

__version__ = "0.1.0"

# The compile cache's directory when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed path inside the checkout (the path is part of the cache key).
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Persist compiled XLA programs across processes; returns the
    directory in use. Kernel shapes are canonical, so one-shot CLI runs
    and serving processes reuse each other's compiles. When
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it and no directory is
    set here."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return jax.config.jax_compilation_cache_dir
