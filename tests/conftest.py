import pathlib
import sys
import types

import pytest

# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 CPU device
# (the 512-device override lives only in launch/dryrun.py). Multi-device
# tests spawn subprocesses (tests/test_distributed.py).
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


@pytest.fixture(autouse=True)
def _reset_kernel_registry():
    """The kernel registry's one-time warnings and fallback counters are
    module-global ("once per process"); reset them around every test so
    no test leaks warning state into another — the bug the old
    ``ivf_scan.ops._pallas_fallback_warned`` global had."""
    from repro.kernels import registry

    registry.reset_warnings()
    yield
    registry.reset_warnings()

try:
    from hypothesis import settings, HealthCheck

    settings.register_profile(
        "ci", max_examples=20, deadline=None,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large])
    settings.load_profile("ci")
except ModuleNotFoundError:
    # hypothesis is an optional dev dependency (see requirements.txt).
    # Install a stub so `from hypothesis import given, strategies as st`
    # keeps importing; @given-decorated tests are skipped, everything
    # else in those modules still runs.
    import pytest

    def _given(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (property-based test)")(fn)
        return deco

    def _strategy(*_args, **_kwargs):
        return None

    hyp = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")
    st.__getattr__ = lambda name: _strategy          # PEP 562
    hyp.given = _given
    hyp.strategies = st
    hyp.settings = types.SimpleNamespace(
        register_profile=lambda *a, **k: None,
        load_profile=lambda *a, **k: None)
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips on hosts without one")
