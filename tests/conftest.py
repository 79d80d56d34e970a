"""Test configuration: force JAX onto a virtual 8-device CPU mesh so
sharding paths are exercised without accelerator hardware.

Set CONSENT_TESTS_ON_DEVICE=1 to keep the real backend instead; the
`gpu`-marked tests then run on the card:

    CONSENT_TESTS_ON_DEVICE=1 python -m pytest -m gpu tests/

Without a GPU they skip (decided per test by the fixture below, never
while modules are imported)."""

import os

import jax  # noqa: E402
import pytest

if os.environ.get("CONSENT_TESTS_ON_DEVICE") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")

from consent_jax.utils.jaxcache import enable  # noqa: E402

enable()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (CONSENT_TESTS_ON_DEVICE=1)")
