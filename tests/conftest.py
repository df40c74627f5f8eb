"""Test configuration: force CPU with 8 virtual devices.

Tests run the same jitted code the GPU runs; an 8-device host mesh
exercises the multi-device sharding paths (SURVEY.md §4 test strategy).
With JAX_PLATFORMS unset the platform is forced to CPU, so a bare
`pytest` on a machine with a card still tests the CPU; tests marked
`gpu` run where JAX_PLATFORMS names the card (README, "Tests").
XLA_FLAGS must be set before the backend initializes.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

