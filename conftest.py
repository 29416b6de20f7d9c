"""Repo-root pytest bootstrap.

By default the tests run on a virtual 8-device CPU mesh (multi-device
sharding paths are exercised without accelerator hardware, SURVEY.md
section 4.4) with float64 enabled, so kernels can be validated against
scipy's float64 oracles at tight tolerances.  The platform is pinned
through ``jax.config`` because JAX may already be imported when this
file runs; backends initialize lazily, so that still takes effect.

``AUDIAN_DEVICE_TESTS=1`` leaves the platform alone for the ``gpu``-marked
device suite (``tests/test_device_gpu.py``), which runs on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

ON_DEVICE = bool(os.environ.get("AUDIAN_DEVICE_TESTS"))

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    # float64 so kernels can be validated against scipy float64 oracles
    # at tight tolerances; NOT set for the device suite, which compares
    # f32 device outputs against host oracles
    jax.config.update("jax_enable_x64", True)
    assert jax.default_backend() == "cpu", \
        "tests must run on the virtual CPU mesh"
    assert jax.device_count() >= 8

# Opt-in line coverage on sys.monitoring (no external deps;
# tools/linecov.py): AUDIAN_TPU_COV=1 records executed lines and dumps
# .linecov.json at exit for `python tools/linecov.py report`.
if os.environ.get("AUDIAN_TPU_COV"):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent / "tools"))
    import linecov

    linecov.start()
