import os

# Tests see ONE device (the dry-run sets its own 512-device flag in-process;
# never set that here -- see the brief).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (a CUDA kernel); skips without one")
