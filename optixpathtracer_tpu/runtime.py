"""Process-level set-up shared by the entry points: the persistent compile
cache, and what a measurement needs to say about the device it ran on."""
from __future__ import annotations

import os
import subprocess

# Fixed, inside the checkout and listed in .gitignore: the cache directory is
# part of each entry's key, so a path that moves between runs never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


# Split each GPU program's LLVM module and compile the parts in parallel:
# the rendering programs are large (the layered-BSDF training step is ~10 MB
# of GPU code), and codegen was a serial minute of it.
XLA_FLAGS = ("--xla_gpu_enable_llvm_module_compilation_parallelism=true",)


def set_xla_flags():
    """Add the program's XLA_FLAGS to the environment. XLA reads them once,
    when the first backend starts, so entry points call this before any
    JAX computation; flags already set by the user are kept."""
    flags = os.environ.get("XLA_FLAGS", "")
    for flag in XLA_FLAGS:
        if flag.split("=")[0] not in flags:
            flags = f"{flags} {flag}".strip()
    os.environ["XLA_FLAGS"] = flags


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache, in
    $JAX_COMPILATION_CACHE_DIR when that is set, else DEFAULT_CACHE_DIR.
    Returns the directory."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def card_info() -> str:
    """`name, power.limit` of each NVIDIA card as nvidia-smi reports them,
    read by a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def require_gpu():
    """The first JAX device, which must be a GPU: measurements and the chip
    smoke refuse to report CPU numbers under a device's name."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {dev.platform!r} "
                           f"({dev.device_kind})")
    return dev
