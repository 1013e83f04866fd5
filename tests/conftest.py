import os
import sys

# The tests run on the CPU: a virtual 8-device CPU mesh for the sharding
# tests. jax may already be imported, so the config is set after import
# too. Tests that need a GPU carry the `gpu` marker and decide in a
# fixture (gpu_available) whether one is present; `pytest -m gpu` on a
# machine with a card runs them.
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE)


requires_reference = pytest.mark.skipif(
    not reference_available(), reason="reference fixtures not mounted")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on a host without one")


def device_env() -> dict:
    """The environment a child process gets to see the real devices (this
    process is held to the CPU)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="session")
def gpu_available():
    """Skip unless JAX, run outside this CPU-held process, finds a GPU."""
    import subprocess

    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, env=device_env(), timeout=300)
    if r.returncode != 0 or r.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU on this host")
