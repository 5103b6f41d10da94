"""pytest plugin: the port's four runtime verifiers as test guards.

Run a suite with it and the four ``XLLM_*_DEBUG`` variables set, and every
test doubles as a race, snapshot, ownership and leak detector for the
port's own classes::

    XLLM_LOCK_DEBUG=1 XLLM_RCU_DEBUG=1 XLLM_STATE_DEBUG=1 \\
    XLLM_LEAK_DEBUG=1 python -m pytest \\
        -p xllm_service_tpu_torch.testing.debug_guard tests/test_torch_...

Each guard is the counterpart of one of ``tests/conftest.py``'s fixtures
(which watch the reference's verifiers); with its variable unset a guard
does nothing. A violation recorded during a test fails the test, and so
does a nonzero balance of a ``strict`` lifecycle pair at its teardown.
"""

from __future__ import annotations

import time

import pytest

from ..devtools import lifecycle as _lifecycle
from ..devtools import locks as _locks
from ..devtools import ownership as _ownership
from ..devtools import rcu as _rcu

#: How long a test's teardown waits for its strict lifecycle balances to
#: return to zero before it reports a leak.
STRICT_SETTLE_S = 2.0


@pytest.fixture(autouse=True)
def _torch_lock_guard():
    """Lock-order inversions and holds across fault points
    (``XLLM_LOCK_DEBUG``)."""
    if not _locks.debug_enabled():
        yield
        return
    _locks.reset_violations()
    yield
    vs = _locks.violations()
    assert not vs, ("port instrumented-lock violations:\n"
                    + "\n".join(str(v) for v in vs))


@pytest.fixture(autouse=True)
def _torch_state_guard():
    """Writes that break a declared state discipline
    (``XLLM_STATE_DEBUG``)."""
    if not _ownership.debug_enabled():
        yield
        return
    _ownership.reset_violations()
    yield
    vs = _ownership.violations()
    assert not vs, ("port state-ownership violations:\n"
                    + "\n".join(str(v) for v in vs))


@pytest.fixture(autouse=True)
def _torch_leak_guard():
    """Double releases, resurrected series and strict-pair leaks
    (``XLLM_LEAK_DEBUG``)."""
    if not _lifecycle.debug_enabled():
        yield
        return
    _lifecycle.reset_violations()
    _lifecycle.reset_balances()
    yield
    # A request's exit runs on the ingest thread after its client has the
    # last byte, so a test may end a moment before its slot is released:
    # give the strict balances a bounded window to settle.
    deadline = time.monotonic() + STRICT_SETTLE_S
    while _lifecycle.strict_imbalances() and time.monotonic() < deadline:
        time.sleep(0.02)
    vs = _lifecycle.violations() + _lifecycle.strict_imbalances()
    assert not vs, ("port lifecycle pair violations:\n"
                    + "\n".join(str(v) for v in vs))


@pytest.fixture(autouse=True)
def _torch_rcu_guard():
    """In-place mutation of a published snapshot (``XLLM_RCU_DEBUG``)."""
    if not _rcu.debug_enabled():
        yield
        return
    _rcu.reset_violations()
    yield
    vs = _rcu.violations()
    assert not vs, ("port rcu deep-freeze violations:\n"
                    + "\n".join(str(v) for v in vs))
