"""Runner threads: an object (an env runner, an IMPALA aggregator) hosted
on a thread of its own in the driver process, where the reference hosts
it as a runtime actor (``ray_tpu/rllib/env_runner.py:196-201``,
``impala.py:103-108``).

A :class:`RunnerThread` builds its object on a single-worker
``ThreadPoolExecutor``: the object keeps its own state, and the calls
made on it run one at a time in the order they were made, as an actor's
do. :meth:`RunnerThread.call` returns a ``concurrent.futures.Future``,
which stands in for an object ref; :func:`get` and :func:`wait` stand in
for ``rt.get`` and ``rt.wait``, and every wait has a timeout.

Threads, not processes: the configurations pass lambdas and classes
defined inside functions as env creators, mapping functions and
connectors, which ``pickle`` cannot send to a spawned process. The
runners' numpy work shares the driver's interpreter lock.
"""
from __future__ import annotations

import concurrent.futures as cf
import time
from typing import Any, Callable, List, Sequence, Tuple

#: Seconds a weight sync or a metrics read may wait (the reference's
#: ``rt.get(..., timeout=60)``).
SYNC_TIMEOUT_S = 60.0
#: Seconds a batch of samples may take (``timeout=300``), and a runner
#: its construction.
SAMPLE_TIMEOUT_S = 300.0


class RunnerThread:
    """``cls(*args, **kwargs)`` built and called on one thread of its own
    (named ``name``)."""

    def __init__(self, cls: Callable, *args, name: str = "runner",
                 **kwargs):
        self._pool = cf.ThreadPoolExecutor(1, thread_name_prefix=name)
        self._obj: Any = None

        def build():
            self._obj = cls(*args, **kwargs)

        try:
            get([self._pool.submit(build)], timeout=SAMPLE_TIMEOUT_S)
        except BaseException:
            self._pool.shutdown(wait=False, cancel_futures=True)
            raise

    def call(self, method: str, *args, **kwargs) -> cf.Future:
        """Queue ``obj.method(*args, **kwargs)`` behind the calls already
        made; its future."""
        return self._pool.submit(
            lambda: getattr(self._obj, method)(*args, **kwargs))

    def stop(self) -> None:
        """Drop the queued calls, wait for the running one, end the
        thread."""
        self._pool.shutdown(wait=True, cancel_futures=True)


def get(futures: Sequence[cf.Future], timeout: float) -> List[Any]:
    """The futures' results in order (a call's exception raises here);
    ``TimeoutError`` if any is not done within ``timeout`` seconds."""
    _, pending = cf.wait(futures, timeout=timeout)
    if pending:
        raise TimeoutError(f"{len(pending)} of {len(futures)} runner calls "
                           f"not done within {timeout} s")
    return [f.result() for f in futures]


def wait(futures: Sequence[cf.Future], num_returns: int = 1,
         timeout: float = SYNC_TIMEOUT_S
         ) -> Tuple[List[cf.Future], List[cf.Future]]:
    """``(ready, not_ready)``, each in the order given: returns once
    ``num_returns`` futures are done or ``timeout`` seconds have passed
    (``timeout=0`` only looks), with at most ``num_returns`` ready."""
    deadline = time.monotonic() + timeout
    pending = [f for f in futures if not f.done()]
    while len(futures) - len(pending) < num_returns and pending:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        _, still = cf.wait(pending, timeout=left,
                           return_when=cf.FIRST_COMPLETED)
        pending = list(still)
    done = [f for f in futures if f.done()][:num_returns]
    chosen = set(done)
    return done, [f for f in futures if f not in chosen]
