"""Fixtures for the port's runtime tests (``test_torch_core*.py`` and
their siblings import them).

:func:`rt_port` starts one ``ray_tpu_torch`` runtime for a whole test
module (8 CPUs, and ``RT_NUM_GPUS`` advertised GPUs where the module sets
it: a GPU resource needs no card) and shuts it down after the module's
last case: starting a
runtime per case would cost a head and fresh worker processes each
time. ``OMP_NUM_THREADS=1`` is set before ``init``, so the worker
processes the head spawns (they inherit its environment) do not each
start a pool of one thread per core beside the suite's other workers
(``torch_threads.py`` does the same for the test process).

:func:`case_time_limit` gives every case of a module that imports it a
time limit of its own (``CASE_LIMIT_S`` in the module, else
:data:`CASE_LIMIT_S`): a hung runtime call fails its case instead of
holding the worker until the suite's watchdog.
"""
import os
import signal

import pytest

#: Seconds a case may take unless its module sets ``CASE_LIMIT_S``.
CASE_LIMIT_S = 60.0


class CaseTimeout(Exception):
    """A case ran past its time limit."""


@pytest.fixture(scope="module")
def rt_port(request):
    import ray_tpu_torch as rt

    prev = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, num_gpus=getattr(request.module, "RT_NUM_GPUS", 0))
    try:
        yield rt
    finally:
        rt.shutdown()
        if prev is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prev


@pytest.fixture(autouse=True)
def case_time_limit(request):
    limit = float(getattr(request.module, "CASE_LIMIT_S", CASE_LIMIT_S))

    def _raise(signum, frame):
        raise CaseTimeout(f"{request.node.nodeid} exceeded its {limit} s "
                          "limit")

    prev = signal.signal(signal.SIGALRM, _raise)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)
