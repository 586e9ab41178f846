"""Dashboard-lite: the head's HTTP observability endpoint.

The port's copy of ``ray_tpu/_private/dashboard.py``.

Capability parity with the reference's dashboard head + metrics exporter
(reference: ``python/ray/dashboard/head.py:81`` aiohttp app;
``src/ray/stats`` prometheus exporter), collapsed into one dependency-free
asyncio HTTP server on the head:

- ``GET /metrics``        → prometheus text (cluster-merged)
- ``GET /api/state?kind=``→ JSON state listing (nodes/workers/actors/…)
- ``GET /api/timeline``   → chrome://tracing JSON events
- ``GET /``               → tiny HTML index linking the above

No aiohttp in the image, so requests are parsed by hand (GET only).
"""
from __future__ import annotations

import asyncio
import json
import os
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse


def _load_index_html() -> str:
    """The SPA ships as a sibling asset (dashboard_index.html): tabbed
    cluster/jobs/actors/workers/data/events views over /api/state,
    /api/node (per-node agent stats), /api/logs (worker log tail),
    /api/jobs + /api/job_logs, and the timeline export — the reference
    dashboard's core views (dashboard/client/src, ~22k-line React)
    rebuilt as one dependency-free page. Falls back to the embedded
    minimal page if the asset is missing from a stripped install."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dashboard_index.html")
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return _FALLBACK_HTML


# Minimal fallback UI (the full SPA lives in dashboard_index.html).
_FALLBACK_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.5rem;color:#222}
 h1{font-size:1.2rem} h2{font-size:1rem;margin:1.2rem 0 .3rem}
 table{border-collapse:collapse;font-size:.85rem;width:100%}
 th,td{border:1px solid #ddd;padding:.25rem .5rem;text-align:left}
 th{background:#f5f5f5} tr:nth-child(even){background:#fafafa}
 .pill{display:inline-block;padding:0 .5rem;border-radius:1rem}
 .ALIVE{background:#d9f2d9}.DEAD{background:#f7d4d4}
 .links a{margin-right:1rem} #err{color:#b00}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<div class="links"><a href="/metrics">prometheus metrics</a>
<a href="/api/timeline">chrome trace</a>
<a href="/api/state?kind=summary">raw state</a></div>
<div id="err"></div>
<h2>Summary</h2><table id="summary"></table>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Workers</h2><table id="workers"></table>
<h2>Placement groups</h2><table id="placement_groups"></table>
<script>
async function fetchState(kind){
  const r = await fetch('/api/state?kind='+kind);
  if(!r.ok) throw new Error(kind+': '+r.status);
  return r.json();
}
function cell(v){
  const s = (v && typeof v === 'object') ? JSON.stringify(v) : String(v);
  // Escape before innerHTML insertion: state values carry user strings
  // (actor names, error text) that must never execute as markup.
  return s.replace(/&/g,'&amp;').replace(/</g,'&lt;')
          .replace(/>/g,'&gt;').replace(/"/g,'&quot;');
}
function renderRows(id, rows){
  const t = document.getElementById(id);
  if(!rows || !rows.length){ t.innerHTML = '<tr><td>none</td></tr>'; return; }
  const cols = Object.keys(rows[0]);
  let html = '<tr>'+cols.map(c=>'<th>'+c+'</th>').join('')+'</tr>';
  for(const row of rows){
    html += '<tr>'+cols.map(c=>{
      const v = cell(row[c]);
      const pill = (c==='state'||c==='status')
        ? ' class="pill '+v+'"' : '';
      return '<td><span'+pill+'>'+v+'</span></td>';
    }).join('')+'</tr>';
  }
  t.innerHTML = html;
}
async function refresh(){
  try{
    const s = await fetchState('summary');
    document.getElementById('summary').innerHTML =
      Object.entries(s).map(([k,v]) =>
        '<tr><th>'+k+'</th><td>'+cell(v)+'</td></tr>').join('');
    for(const kind of ['nodes','actors','workers','placement_groups'])
      renderRows(kind, await fetchState(kind));
    document.getElementById('err').textContent = '';
  }catch(e){ document.getElementById('err').textContent = e; }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


async def read_get_request(reader):
    """Parse a GET request line + drain headers; returns (path, query
    dict) or None for non-GET. Shared by the head dashboard and the
    per-node agents — one HTTP parser to maintain."""
    request = await asyncio.wait_for(reader.readline(), 10)
    while True:  # drain headers
        line = await asyncio.wait_for(reader.readline(), 10)
        if line in (b"\r\n", b"\n", b""):
            break
    parts = request.decode("latin1").split()
    if len(parts) < 2 or parts[0] != "GET":
        return None
    url = urlparse(parts[1])
    return url.path, {k: v[0] for k, v in parse_qs(url.query).items()}


async def respond(writer, code: int, ctype: str, body: bytes):
    reason = {200: "OK", 404: "Not Found", 405: "Method Not Allowed"}
    head = (f"HTTP/1.1 {code} {reason.get(code, '?')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode()
    writer.write(head + body)
    await writer.drain()


class DashboardServer:
    def __init__(self, state_fn: Callable[[str], object],
                 metrics_fn: Callable[[], str],
                 timeline_fn: Callable[[], list],
                 log_fn=None, node_fn=None,
                 jobs_fn=None, job_logs_fn=None,
                 host: str = "127.0.0.1", port: int = 0):
        self._state_fn = state_fn
        self._metrics_fn = metrics_fn
        self._timeline_fn = timeline_fn
        # async (query dict) -> {"data": str}|{"files": [...]}; serves
        # /api/logs (reference: dashboard log module).
        self._log_fn = log_fn
        # async (query dict with node_id) -> stats dict; serves
        # /api/node — the head proxying every node's agent (reference:
        # dashboard head aggregating per-node agents).
        self._node_fn = node_fn
        # async () -> [job records] and async (query) -> {"logs": str};
        # serve /api/jobs + /api/job_logs (reference: dashboard job
        # module routes).
        self._jobs_fn = jobs_fn
        self._job_logs_fn = job_logs_fn
        self._host = host
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self):
        self._server = await asyncio.start_server(
            self._serve, host=self._host, port=self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    async def stop(self):
        if self._server:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        try:
            parsed = await read_get_request(reader)
            if parsed is None:
                await self._respond(writer, 405, "text/plain",
                                    b"GET only")
                return
            path, q = parsed
            if path == "/metrics":
                body = self._metrics_fn().encode()
                await self._respond(
                    writer, 200, "text/plain; version=0.0.4", body)
            elif path == "/api/state":
                data = self._state_fn(q.get("kind", "summary"))
                await self._respond(writer, 200, "application/json",
                                    json.dumps(data).encode())
            elif path == "/api/timeline":
                await self._respond(
                    writer, 200, "application/json",
                    json.dumps(self._timeline_fn()).encode())
            elif path == "/api/node" and self._node_fn is not None:
                try:
                    data = await self._node_fn(q)
                    await self._respond(writer, 200, "application/json",
                                        json.dumps(data).encode())
                except Exception as e:  # noqa: BLE001 - unknown node
                    await self._respond(writer, 404, "application/json",
                                        json.dumps(
                                            {"error": str(e)}).encode())
            elif path == "/api/jobs" and self._jobs_fn is not None:
                data = await self._jobs_fn()
                await self._respond(writer, 200, "application/json",
                                    json.dumps(data).encode())
            elif path == "/api/job_logs" and self._job_logs_fn is not None:
                try:
                    data = await self._job_logs_fn(q)
                    await self._respond(writer, 200, "application/json",
                                        json.dumps(data).encode())
                except Exception as e:  # noqa: BLE001 - unknown job
                    await self._respond(writer, 404, "application/json",
                                        json.dumps(
                                            {"error": str(e)}).encode())
            elif path == "/api/logs" and self._log_fn is not None:
                try:
                    data = await self._log_fn(q)
                    await self._respond(writer, 200, "application/json",
                                        json.dumps(data).encode())
                except Exception as e:  # noqa: BLE001 - missing log file
                    await self._respond(writer, 404, "application/json",
                                        json.dumps(
                                            {"error": str(e)}).encode())
            elif path == "/":
                await self._respond(writer, 200, "text/html",
                                    _load_index_html().encode())
            else:
                await self._respond(writer, 404, "text/plain",
                                    b"not found")
        except Exception:  # noqa: BLE001 - a bad client mustn't kill the head
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    _respond = staticmethod(respond)
