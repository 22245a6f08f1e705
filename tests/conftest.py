"""Shared fixtures: the runtime sanitizer harness (src/repro/sanitize.py).

``sanitized_run`` gives a test the stacked sanitizers (transfer guard +
NaN debugging + compile counter) as a context factory; the ``sanitized``
marker documents which tests exercise device paths under the guard (CI
selects them with ``-m sanitized`` for the sanitized tier-1 subset).
"""
import pytest

from repro import sanitize


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "sanitized: runs device paths under jax.transfer_guard('disallow') "
        "+ debug_nans + the compile-event counter")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is false")


@pytest.fixture
def sanitized_run():
    """Factory for sanitizer scopes: ``with sanitized_run() as ev: ...``.
    Stage device operands explicitly (device_put/jnp.asarray) before
    entering — implicit transfers inside the scope raise."""
    return sanitize.sanitized


@pytest.fixture
def compile_events():
    """Compile-event counter scope (no transfer/NaN guards)."""
    return sanitize.compile_events
