"""Test configuration.

The suite runs on the CPU by default (``JAX_PLATFORMS=cpu`` unless the
caller sets another platform), with a virtual 8-device host mesh, so the
sharded hosts are checked on one machine exactly as ``dryrun_multichip``
does.  x64 is enabled so physics invariants can be checked at reference
(double) precision.  Pallas kernels run here in interpret mode.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them when JAX finds no GPU.  On a machine
with a card run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

from edm_tpu.utils.compile_cache import enable_compile_cache

# the suite's cost is dominated by XLA:CPU compiles of the same step
# programs run to run; the persistent cache keeps them across runs
enable_compile_cache()

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def fixture_dir():
    d = REFERENCE / "tests"
    if not d.exists():
        pytest.skip("reference fixtures unavailable")
    return d


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu"
        )
    return dev


@pytest.fixture
def triton_interpret(monkeypatch):
    """Runs the Triton force kernel in the Pallas interpreter wherever a
    host asks for it (the hosts compile it for the GPU)."""
    import edm_tpu.ops.cellforce_triton as CT

    orig = CT.pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(CT.pl, "pallas_call", interp_call)


@pytest.fixture(autouse=True)
def _clear_jax_caches_after_slow(request):
    """The slow profile compiles many large interpret-mode Pallas programs
    in one process; dropping the jit caches between slow cases trades
    recompiles for a bounded compiler footprint."""
    yield
    if "slow" in request.keywords:
        jax.clear_caches()
