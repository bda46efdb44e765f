"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip sharding is validated on host CPU devices per the build plan
(SURVEY.md §4, item e).  Environment variables must be set before the first
jax import anywhere in the test process.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pin the platform after the import too: an installed plugin may set
# jax_platforms itself when jax is imported.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DATA = "/root/reference/data"


@pytest.fixture(scope="session")
def hhi_yaml_path():
    path = os.path.join(REFERENCE_DATA, "ESL_calib_hhi.yaml")
    if not os.path.exists(path):
        pytest.skip("reference calibration data not available")
    return path


@pytest.fixture(scope="session")
def nebra_yaml_path():
    path = os.path.join(REFERENCE_DATA, "nebra_evk3.0", "X-maps_calibration_8_5mm.yaml")
    if not os.path.exists(path):
        pytest.skip("reference calibration data not available")
    return path


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
