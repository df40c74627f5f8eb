"""Process set-up shared by the entry points: JAX's persistent compile
cache and the accelerator check.

Call these from `main()` of a script or CLI, never at import: importing a
module must not configure JAX or touch a device.
"""

from __future__ import annotations

import os
import subprocess

#: where the compile cache lives when JAX_COMPILATION_CACHE_DIR is unset.
#: A fixed path, because the directory is part of what makes a later
#: process find an earlier one's entries.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  JAX_COMPILATION_CACHE_DIR, when set, is used as it is
    (JAX reads it itself) and no other directory is set; otherwise the
    cache goes to REPO_CACHE_DIR."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu():
    """The first JAX device, which must be a GPU.  Measurement entry
    points call this so that a run without the card fails instead of
    timing the CPU under a device metric's name."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); this entry point measures the GPU only"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of every visible card, as nvidia-smi prints
    them (read in a child process that stays off JAX)."""
    out = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class CompileStats:
    """Running totals of this process's JAX compile events: seconds in
    the backend compiler and persistent-cache hits and misses.  Create
    one at start-up; read `snapshot()` before and after a phase."""

    def __init__(self):
        from jax import monitoring

        self.compile_s = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        monitoring.register_event_duration_secs_listener(self._on_duration)
        monitoring.register_event_listener(self._on_event)

    def _on_duration(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.cache_misses += 1

    def snapshot(self):
        return self.compile_s, self.cache_hits, self.cache_misses
