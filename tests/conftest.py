import os
import sys

# run JAX on a virtual 8-device CPU mesh for sharding tests; the real-TPU
# bench path is exercised by bench.py, not the unit suite
os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

# the site customization in this image pins the platform at jax import time,
# overriding the env var; force the CPU backend via the config API too
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference"


def ref_path(*parts):
    return os.path.join(REF, *parts)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
