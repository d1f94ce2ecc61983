"""``serve.graphs.no_gc``, the guard around every CUDA graph capture: no
automatic garbage collection inside it (a collection there may finalize
an unreachable graph program, a call a capture does not permit), and the
collector's state restored after it, on an exception too."""
import gc

import pytest

from repro_torch.serve.graphs import no_gc


class _Cycle:
    """An object in a reference cycle whose finalizer records that it
    ran (as an unreachable graph program's would destroy its graph)."""

    def __init__(self, log):
        self.log = log
        self.me = self

    def __del__(self):
        self.log.append("finalized")


def test_no_collection_inside_and_restored_after():
    assert gc.isenabled()
    log = []
    with no_gc():
        assert not gc.isenabled()
        _Cycle(log)
        for _ in range(200_000):  # enough allocations to trigger the GC
            [[]]
        assert log == []
    assert gc.isenabled()
    gc.collect()
    assert log == ["finalized"]


def test_restored_on_an_exception():
    with pytest.raises(RuntimeError):
        with no_gc():
            raise RuntimeError("capture failed")
    assert gc.isenabled()


def test_leaves_a_disabled_collector_disabled():
    gc.disable()
    try:
        with no_gc():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()
