"""Process set-up shared by the entry points (the CLI, bench.py,
chip_smoke.py): JAX's persistent compile cache, and a description of the
accelerator a run measures on."""
from __future__ import annotations

import os
import subprocess

# the checkout this package lives in; the default cache directory is
# listed in .gitignore
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Place JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to one fixed path in
    the checkout: the path is part of the cache key, so a directory that
    moved between runs would never hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """The first JAX device; raises RuntimeError unless it is a GPU, so a
    measurement never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev})")
    return dev


def device_info() -> dict:
    """platform, device_kind and device count as JAX reports them."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def gpu_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them (a
    child process, so it never touches JAX); a card can be set below its
    maximum power and then runs slower under load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())
