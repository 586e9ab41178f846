"""RPC deadline + task-retention tests of the port's ``_private/rpc.py``
(the cases of ``test_rpc_deadline.py``), and the server's stop once a
client has gone.

Two defects would each hang a caller:
  1. serve tasks were fire-and-forget ``create_task`` calls with no strong
     reference — asyncio keeps only weak refs, so GC pressure could
     collect a serve task mid-execution and its reply was never sent;
  2. control-plane callers had no deadline, so a lost reply hung forever.
These tests pin both fixes: lost replies surface as ``RpcError`` within
the deadline, and serve tasks are strongly referenced until done.
"""
import asyncio
import gc

import pytest

from ray_tpu_torch._private import rpc
from torch_runtime import case_time_limit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_call_simple_deadline_on_lost_reply(tmp_path):
    """A handler that never replies must fail the caller at the deadline
    with the method name in the error — not hang."""
    path = str(tmp_path / "srv.sock")

    async def go():
        hung = asyncio.Event()

        async def handler(method, payload, bufs, conn):
            if method == "blackhole":
                hung.set()
                await asyncio.Event().wait()  # never replies
            return {"ok": True}

        server = await rpc.RpcServer(handler, path=path).start()
        conn = await rpc.connect(path)
        try:
            # Sanity: normal call works with a deadline.
            assert (await conn.call_simple("ping", {}, timeout=5.0))["ok"]
            with pytest.raises(rpc.RpcError, match="blackhole"):
                await conn.call_simple("blackhole", {}, timeout=0.5)
            assert hung.is_set()
            # Connection survives a timed-out call: next call still works.
            assert (await conn.call_simple("ping", {}, timeout=5.0))["ok"]
            # The timed-out request no longer leaks a pending future.
            assert not conn._pending
        finally:
            await conn.close()
            await server.stop()

    asyncio.run(go())


def test_serve_tasks_survive_gc(tmp_path):
    """Serve tasks must be strongly referenced: run requests whose handler
    yields across an aggressive gc.collect() and require every reply to
    arrive. (Before the fix the loop held only weak refs to these tasks.)"""
    path = str(tmp_path / "srv.sock")

    async def go():
        async def handler(method, payload, bufs, conn):
            # Suspend so the serve task is alive across collections.
            await asyncio.sleep(0.01)
            return {"n": payload["n"]}

        server = await rpc.RpcServer(handler, path=path).start()
        conn = await rpc.connect(path)
        try:
            futs = [conn.send_request("echo", {"n": i}) for i in range(64)]
            for _ in range(5):
                gc.collect()
                await asyncio.sleep(0.005)
            payloads = [
                (await asyncio.wait_for(f, 10))[0] for f in futs]
            assert sorted(p["n"] for p in payloads) == list(range(64))
        finally:
            await conn.close()
            await server.stop()

    asyncio.run(go())


def test_spawn_keeps_strong_reference():
    async def go():
        saw = asyncio.Event()

        async def bg():
            await asyncio.sleep(0.01)
            saw.set()

        t = rpc.spawn(bg())
        assert t in rpc._background_tasks
        gc.collect()
        await asyncio.wait_for(saw.wait(), 5)
        await asyncio.sleep(0)  # let the done-callback run
        assert t not in rpc._background_tasks

    asyncio.run(go())


def test_stop_after_client_left_is_prompt(tmp_path):
    """A client that closed first leaves no open transport behind, so
    ``RpcServer.stop`` returns at once instead of after its 5 s
    ``wait_closed`` backstop (the head's stop after the driver left)."""
    import time

    path = str(tmp_path / "srv.sock")

    async def go():
        async def handler(method, payload, bufs, conn):
            return {"ok": True}

        server = await rpc.RpcServer(handler, path=path).start()
        conn = await rpc.connect(path)
        assert (await conn.call_simple("ping", {}, timeout=5.0))["ok"]
        await conn.close()
        for _ in range(100):
            if not server.connections:
                break
            await asyncio.sleep(0.01)
        t0 = time.monotonic()
        await server.stop()
        return time.monotonic() - t0

    assert asyncio.run(go()) < 1.0
