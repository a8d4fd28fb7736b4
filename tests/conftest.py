"""Test configuration: force CPU backend with 8 virtual devices so
multi-chip sharding tests run without accelerator hardware, and persist
XLA compilation across test runs (CPU compiles of the scan-heavy
consensus kernel are expensive).  Tests that only a GPU can run carry
the ``gpu`` marker and skip here."""
import os

# Force (not setdefault): a GPU host's JAX picks the card by default;
# tests must run on the virtual CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"

# A pytest plugin imports jax before this conftest runs, freezing the
# config defaults from the old env — override via jax.config too (the
# backend itself initializes lazily, so this still takes effect).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_platform_name", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

_cache = os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.abspath(_cache))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_ENABLE_XLA_CACHES", "all")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (a CUDA kernel has no interpret mode); "
        "skips on the CPU")
