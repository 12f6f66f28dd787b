"""Test configuration: run on a virtual 8-device CPU mesh by default.

Multi-device sharding is validated without hardware via XLA's host
platform device-count override (SURVEY §4: mesh tests through
``--xla_force_host_platform_device_count``).  Pallas kernels run in
interpret mode there.  Tests marked ``gpu`` need an NVIDIA GPU: they
skip elsewhere, and ``chip_smoke.py`` runs them on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

# Sanitizer runs (CI native-asan / native-tsan jobs, LD_PRELOAD=libasan/
# libtsan) exercise the C++ tier; jaxlib's nanobind bindings cannot throw
# C++ exceptions through the preloaded sanitizer's interceptors
# (AddressSanitizer CHECK: real___cxa_throw == 0 inside MLIR tracing), so
# jit/tracing tests are skipped there — mark them @pytest.mark.needs_jax.
_SANITIZER = any(s in os.environ.get("LD_PRELOAD", "")
                 for s in ("libasan", "libtsan", "libubsan"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "needs_jax: test traces/jits through jaxlib (auto-skipped under "
        "sanitizer LD_PRELOAD, which jaxlib exceptions cannot cross)")
    config.addinivalue_line(
        "markers",
        "gpu: test needs an NVIDIA GPU (skips without one; chip_smoke.py "
        "runs these on the card)")


def pytest_collection_modifyitems(config, items):
    if not _SANITIZER:
        return
    skip = pytest.mark.skip(
        reason="jaxlib tracing cannot run under sanitizer LD_PRELOAD")
    for item in items:
        if "needs_jax" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU
    (decided here, at run time, never while modules import)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on one")
