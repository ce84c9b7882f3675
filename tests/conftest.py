"""Test harness — multi-device-without-a-pod.

The reference runs its whole pytest suite under ``mpirun -np 2`` on
localhost (.travis.yml:100-111) so real collectives exercise the full
negotiation path between two processes. The TPU-native analogue (SURVEY.md
§4) is an 8-device virtual CPU mesh via
``--xla_force_host_platform_device_count`` — the same XLA collectives and
sharding machinery as a real v5e-8, minus the ICI.
"""

import os
import tempfile

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# Persistent XLA compilation cache, shared by the suite and every
# subprocess it spawns (env vars are inherited): the suite compiles
# the same tiny models over and over — each InferenceEngine/worker
# re-jits identical HLO — and the cache collapses the repeats. Keyed
# on HLO + compile options, so mixed device counts are safe; set via
# env (not jax.config) so fleet replicas and bench workers get it too.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "hvdtpu-test-xla-cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                      "0.5")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

import horovod_tpu as hvd  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running subprocess integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


@pytest.fixture(scope="session", autouse=True)
def _init_horovod():
    hvd.init()
    yield


@pytest.fixture(autouse=True)
def _fresh_names():
    # Each op name must be unique among in-flight ops only; tests reuse
    # names freely because they synchronize. Nothing to reset per-test, but
    # keep the hook for engine-level isolation if a test kills the engine.
    yield
