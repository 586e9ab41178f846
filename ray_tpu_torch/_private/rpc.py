"""Minimal high-throughput RPC over unix-domain / TCP sockets.

The port's copy of ``ray_tpu/_private/rpc.py``.

Capability-parity stand-in for the reference's gRPC wrapper layer
(reference: ``src/ray/rpc/grpc_server.h``, ``client_call.h``) designed fresh
for this runtime: asyncio streams, length-prefixed multi-frame messages,
pipelined request/response with 8-byte request ids, and a push (one-way)
mode for data-plane transfers. Control payloads are pickled python objects;
data frames ride as raw buffers (no copy into the pickle stream).

Wire format per message:
    <u32 nframes> <u64 size_0> ... <u64 size_{n-1}> frame_0 ... frame_{n-1}
frame_0 is always the pickled tuple (kind, req_id, method, payload_meta);
remaining frames are out-of-band buffers.
"""
from __future__ import annotations

import asyncio
import itertools
import pickle
import struct
from collections import deque
from typing import Any, Awaitable, Callable, Dict, List, Optional

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_ERROR = 2
KIND_PUSH = 3  # one-way, no response

_req_counter = itertools.count(1)

# Strong references for fire-and-forget tasks. asyncio's event loop keeps
# only WEAK references to tasks (documented in ``loop.create_task``): a
# task whose coroutine is suspended with no other referent can be garbage
# collected mid-execution. For a serve task that means the reply is simply
# never sent — the peer blocks forever with the connection healthy (a
# ``list_nodes`` reply vanishes while the head keeps running). Every
# fire-and-forget task in the runtime must go through ``spawn``.
_background_tasks: set = set()


def spawn(coro, loop=None) -> asyncio.Task:
    """``create_task`` with a strong reference held until the task ends."""
    task = (loop or asyncio.get_running_loop()).create_task(coro)
    _background_tasks.add(task)
    task.add_done_callback(_background_tasks.discard)
    if len(_background_tasks) > 512:
        # A loop closed with tasks still pending never runs their done
        # callbacks — prune those so the strong-ref set can't grow
        # without bound across cluster create/teardown cycles.
        for t in [t for t in _background_tasks if t.get_loop().is_closed()]:
            _background_tasks.discard(t)
    return task


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


async def _read_msg(reader: asyncio.StreamReader) -> List[bytes]:
    head = await reader.readexactly(4)
    (n,) = struct.unpack("<I", head)
    sizes = struct.unpack(f"<{n}Q", await reader.readexactly(8 * n))
    frames = []
    for s in sizes:
        frames.append(await reader.readexactly(s))
    return frames


def _write_msg(writer: asyncio.StreamWriter, frames: List[bytes]) -> None:
    head = struct.pack("<I", len(frames)) + b"".join(
        struct.pack("<Q", len(f)) for f in frames
    )
    writer.write(head)
    for f in frames:
        writer.write(bytes(f) if not isinstance(f, (bytes, bytearray)) else f)


Handler = Callable[[str, Any, List[bytes], "Connection"], Awaitable[Any]]


class Connection:
    """One duplex connection carrying pipelined requests in both directions.

    All outbound traffic funnels through a single writer task that
    streams each message in bounded pieces with flow control. Two
    reasons: (a) asyncio transports compact their write buffer with an
    O(buffered) memmove per socket send, so letting a 64MB reply sit in
    the buffer costs QUADRATIC memmove time (measured: 2 concurrent
    64MB replies = 5s vs 0.4s); (b) senders on different tasks can
    never interleave bytes inside one another's frames."""

    # Max bytes handed to the transport per piece / drain threshold.
    _WRITE_PIECE = 1 << 20
    _WRITE_HIGH = 4 << 20

    def __init__(self, reader, writer, handler: Optional[Handler] = None):
        self._reader = reader
        self._writer = writer
        self._handler = handler
        self._pending: Dict[int, asyncio.Future] = {}
        self._closed = False
        self._recv_task: Optional[asyncio.Task] = None
        self._send_q: "deque" = deque()
        self._send_wake: Optional[asyncio.Event] = None
        self._send_task: Optional[asyncio.Task] = None
        self._send_busy = False  # writer mid-message (cancel = truncation)
        self.on_close: Optional[Callable[[], None]] = None
        try:
            writer.transport.set_write_buffer_limits(
                high=self._WRITE_HIGH, low=self._WRITE_PIECE)
        except Exception:  # noqa: BLE001 - non-standard transport
            pass

    def start(self):
        loop = asyncio.get_running_loop()
        self._send_wake = asyncio.Event()
        self._recv_task = loop.create_task(self._recv_loop())
        self._send_task = loop.create_task(self._send_loop())

    def _enqueue(self, frames: List[bytes]) -> None:
        """Queue one message for the writer task (callers must already
        be on the loop thread; FIFO order == submission order)."""
        self._send_q.append(frames)
        if self._send_wake is not None:
            self._send_wake.set()

    async def _send_loop(self):
        tr = self._writer.transport
        try:
            while True:
                while not self._send_q:
                    self._send_wake.clear()
                    await self._send_wake.wait()
                frames = self._send_q.popleft()
                self._send_busy = True
                views = []
                for f in frames:
                    v = memoryview(f)
                    if v.format != "B" or not v.contiguous:
                        v = memoryview(bytes(f))
                    views.append(v)
                head = struct.pack("<I", len(views)) + b"".join(
                    struct.pack("<Q", v.nbytes) for v in views)
                self._writer.write(head)
                for view in views:
                    for off in range(0, view.nbytes, self._WRITE_PIECE):
                        self._writer.write(view[off:off + self._WRITE_PIECE])
                        if tr.get_write_buffer_size() > self._WRITE_HIGH:
                            await self._writer.drain()
                if tr.get_write_buffer_size() > self._WRITE_HIGH:
                    await self._writer.drain()
                self._send_busy = False
        except asyncio.CancelledError:
            raise
        except (ConnectionResetError, OSError):
            pass

    async def _recv_loop(self):
        try:
            while True:
                frames = await _read_msg(self._reader)
                kind, req_id, method, payload = pickle.loads(frames[0])
                bufs = frames[1:]
                if kind == KIND_REQUEST:
                    spawn(self._serve_one(req_id, method, payload, bufs))
                elif kind == KIND_PUSH:
                    spawn(self._serve_push(method, payload, bufs))
                elif kind == KIND_RESPONSE:
                    fut = self._pending.pop(req_id, None)
                    if fut is not None and not fut.done():
                        fut.set_result((payload, bufs))
                elif kind == KIND_ERROR:
                    fut = self._pending.pop(req_id, None)
                    if fut is not None and not fut.done():
                        fut.set_exception(RpcError(payload))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            # The peer is gone: close our side of the transport too. A
            # server's ``wait_closed`` (3.12) waits for every transport
            # it accepted, so one left open here made the reference's
            # ``RpcServer.stop`` sit out its 5 s backstop whenever a
            # client (the driver, a worker) had disconnected first.
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001 - already closing
                pass
        finally:
            self._fail_all(ConnectionLost("connection closed"))
            if self._send_task is not None:
                self._send_task.cancel()
            if self.on_close:
                self.on_close()

    async def _serve_one(self, req_id, method, payload, bufs):
        try:
            result = await self._handler(method, payload, bufs, self)
            if isinstance(result, tuple) and len(result) == 2 and isinstance(
                result[1], list
            ):
                meta, out_bufs = result
            else:
                meta, out_bufs = result, []
            frames = [pickle.dumps((KIND_RESPONSE, req_id, method, meta))] + out_bufs
            self._enqueue(frames)
        except Exception as e:  # noqa: BLE001 - errors cross the wire
            import traceback

            msg = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            try:
                self._enqueue(
                    [pickle.dumps((KIND_ERROR, req_id, method, msg))])
            except Exception:
                pass

    async def _serve_push(self, method, payload, bufs):
        try:
            await self._handler(method, payload, bufs, self)
        except Exception:
            import traceback

            traceback.print_exc()

    def _fail_all(self, exc):
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    def send_request(self, method: str, payload: Any = None,
                     bufs: List[bytes] = ()) -> asyncio.Future:
        """Write the request synchronously (ordering!) and return the reply
        future. Must be called from the event-loop thread."""
        if self._closed:
            raise ConnectionLost("connection closed")
        req_id = next(_req_counter)
        fut = asyncio.get_running_loop().create_future()
        fut.rt_req_id = req_id  # lets a timed-out call drop its entry O(1)
        self._pending[req_id] = fut
        frames = [pickle.dumps((KIND_REQUEST, req_id, method, payload))] + list(bufs)
        self._enqueue(frames)
        return fut

    async def call(self, method: str, payload: Any = None,
                   bufs: List[bytes] = (), timeout: Optional[float] = None):
        fut = self.send_request(method, payload, bufs)
        if timeout is not None:
            try:
                payload, out_bufs = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                self._pending.pop(getattr(fut, "rt_req_id", None), None)
                raise RpcError(
                    f"rpc '{method}' got no reply within {timeout}s "
                    f"(connection still open — peer lost the request?)")
        else:
            payload, out_bufs = await fut
        return (payload, out_bufs) if out_bufs else (payload, [])

    async def call_simple(self, method: str, payload: Any = None,
                          timeout: Optional[float] = None):
        meta, _ = await self.call(method, payload, timeout=timeout)
        return meta

    def push(self, method: str, payload: Any = None, bufs: List[bytes] = ()):
        if self._closed:
            raise ConnectionLost("connection closed")
        frames = [pickle.dumps((KIND_PUSH, 0, method, payload))] + list(bufs)
        self._enqueue(frames)

    async def close(self):
        self._closed = True
        # Flush BEFORE cancelling the recv task: its finally-block
        # cancels the writer, which would drop queued replies (the peer
        # would see ConnectionLost instead of its result). Wait for the
        # in-flight message too — cancelling mid-message truncates a
        # frame on the wire, corrupting everything already flushed.
        if self._send_task and (self._send_q or self._send_busy):
            for _ in range(200):
                if not self._send_q and not self._send_busy:
                    break
                await asyncio.sleep(0.01)
        if self._recv_task:
            self._recv_task.cancel()
        if self._send_task:
            self._send_task.cancel()
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except Exception:
            pass


class RpcServer:
    def __init__(self, handler: Handler, path: Optional[str] = None,
                 host: Optional[str] = None, port: int = 0):
        self._handler = handler
        self._path = path
        self._host = host
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: List[Connection] = []
        self.on_connect: Optional[Callable[[Connection], None]] = None

    async def start(self):
        if self._path:
            self._server = await asyncio.start_unix_server(
                self._on_client, path=self._path
            )
        else:
            self._server = await asyncio.start_server(
                self._on_client, host=self._host or "127.0.0.1", port=self._port
            )
            self._port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def address(self):
        return self._path or ("127.0.0.1", self._port)

    async def _on_client(self, reader, writer):
        conn = Connection(reader, writer, self._handler)
        self.connections.append(conn)
        conn.on_close = lambda: self.connections.remove(conn) if conn in self.connections else None
        conn.start()
        if self.on_connect:
            self.on_connect(conn)

    async def stop(self):
        # Order matters on 3.12 where ``Server.wait_closed`` blocks until
        # every connection handler finishes: first stop ACCEPTING (so no
        # connection can slip in mid-drain), then close live connections,
        # then wait (timeout as a backstop for handlers that ignore the
        # close). The old drain-after-wait order deadlocked shutdown
        # whenever a client had attached.
        if self._server:
            self._server.close()
        for c in list(self.connections):
            await c.close()
        if self._server:
            try:
                await asyncio.wait_for(self._server.wait_closed(),
                                       timeout=5.0)
            except Exception:
                pass


async def connect(address, handler: Optional[Handler] = None,
                  timeout: float = 10.0) -> Connection:
    async def _null_handler(method, payload, bufs, conn):
        raise RpcError(f"no handler for {method}")

    if isinstance(address, str):
        reader, writer = await asyncio.wait_for(
            asyncio.open_unix_connection(address), timeout
        )
    else:
        host, port = address
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout
        )
    conn = Connection(reader, writer, handler or _null_handler)
    conn.start()
    return conn
