"""Test-session device setup.

The distributed-executor and sharding tests need a multi-device mesh, so the
test session runs with EIGHT virtual CPU devices (deliberately NOT the 512 of
the production dry-run — that flag belongs to launch/dryrun.py alone; see the
note there).  Single-device tests are unaffected: jit without shardings places
on device 0.

Must run before the first jax import anywhere in the session.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Keep hypothesis fast on the 1-core container.  When hypothesis is absent the
# suite must still load: property tests import the skip-stub in
# tests/_hypothesis_stub.py instead.
try:
    from hypothesis import settings
except ModuleNotFoundError:
    settings = None
if settings is not None:
    settings.register_profile("ci", max_examples=20, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with the CUDA toolkit (skips "
        "without one)")
