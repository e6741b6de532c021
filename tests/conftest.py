"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding is
validated without several cards (tiered test strategy, SURVEY.md §4).
XLA_FLAGS must be set before JAX initializes its CPU client.  The platform
is the CPU unless ``JAX_PLATFORMS`` names another: the ``gpu``-marked tests
run on the card with ``JAX_PLATFORMS=cuda`` (see the README).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# entry points the tests call (cli.main) point JAX at the persistent
# compile cache; the tests themselves compile fresh and write no cache
jax.config.update("jax_enable_compilation_cache", False)
