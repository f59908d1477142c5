"""Dependency-free HTTP front door for the telemetry plane (ROADMAP 5c).

Serves a live :class:`~repro_torch.obs.Telemetry` over stdlib
``ThreadingHTTPServer`` — no external packages, works identically in CI
and on a laptop:

- ``GET /healthz``           liveness + plane summary (JSON)
- ``GET /metrics``           Prometheus text exposition (per-replica
  series); ``?view=fleet`` aggregates the ``replica`` label away
- ``GET /traces``            Perfetto-loadable Chrome JSON; mid-run
  exports are clipped at the current virtual clock so in-flight spans
  render truncated-but-well-formed (``?full=1`` exports verbatim)
- ``GET /audit``             audit summary; ``/audit/<program_id>`` the
  program's causal solve→action chain (JSON)
- ``GET /events``            SSE stream of live trace events
  (``?limit=N`` closes after N events, ``?from=SEQ`` resumes a cursor;
  events compacted out of the ring since the cursor are announced with
  a well-formed ``event: gap`` frame, never silently skipped)
- ``GET /slo``               burn-rate status when an SLOMonitor is on
- ``GET /attribution``       critical-path JCT decomposition of every
  completed program + fleet bottleneck rollup (JSON);
  ``/attribution/<program_id>`` one program's span breakdown
- ``GET /drift``             prediction-drift watchdog status (per-
  estimator bias/p50/p90, live alerts) when enabled

The simulation mutates the plane from its own thread while handlers
read; reads that race a dict mutation are retried (`RuntimeError` from
dict-size-changed), which is enough because every structure is
append-only or rebuilt atomically. Scrapes taken after a run completes
are byte-identical across same-seed runs (CI-gated via the regret
verdict).

Wire-up (also done by ``serve.py --http-port``)::

    srv = ObsServer(tel, port=8321, clock=lambda: cluster.clock.now)
    srv.start()
    ... run ...
    srv.stop()
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.obs import export as obs_export
from repro_torch.obs.registry import aggregate

_PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsServer:
    def __init__(self, tel, host: str = "127.0.0.1", port: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 poll_s: float = 0.05):
        self.tel = tel
        self.clock = clock            # virtual-clock read, for /traces clip
        self.poll_s = poll_s          # SSE idle poll interval (wall time)
        self._stopping = False
        srv = self

        class _Handler(BaseHTTPRequestHandler):
            # Content-Length is set on every non-SSE response, so
            # keep-alive is safe; SSE responses close the connection
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):   # keep CI logs clean
                pass

            def do_GET(self):
                srv._route(self)

        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def start(self) -> "ObsServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="obs-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping = True
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- routing
    def _route(self, h) -> None:
        parsed = urlparse(h.path)
        path, q = parsed.path.rstrip("/") or "/", parse_qs(parsed.query)
        try:
            if path == "/healthz":
                self._healthz(h)
            elif path == "/metrics":
                self._metrics(h, q)
            elif path == "/traces":
                self._traces(h, q)
            elif path == "/audit" or path.startswith("/audit/"):
                self._audit(h, path)
            elif path == "/events":
                self._events(h, q)
            elif path == "/slo":
                self._slo(h)
            elif path == "/attribution" or path.startswith("/attribution/"):
                self._attribution(h, path)
            elif path == "/drift":
                self._drift(h)
            else:
                self._send(h, 404, b"not found\n", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass            # client went away mid-stream

    @staticmethod
    def _send(h, code: int, body: bytes, ctype: str,
              extra: Optional[dict] = None) -> None:
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(body)

    def _read(self, fn, tries: int = 6):
        """Run a read against the live plane; retry the rare race where
        the sim thread resizes a dict mid-iteration."""
        for _ in range(tries - 1):
            try:
                return fn()
            except RuntimeError:
                time.sleep(0.002)
        return fn()

    def _json(self, h, obj, code: int = 200) -> None:
        body = (json.dumps(obj, sort_keys=True, indent=2) + "\n").encode()
        self._send(h, code, body, "application/json")

    # ----------------------------------------------------------- endpoints
    def _healthz(self, h) -> None:
        tel = self.tel
        out = {"status": "ok",
               "replicas": sorted(getattr(tel, "replicas", ())),
               "trace_events": len(tel.trace),
               "trace_seq": tel.trace.seq,
               "dropped_events": tel.trace.dropped,
               "audit_records": len(tel.audit.records),
               "audit_links": len(tel.audit.links),
               "slo": tel.slo is not None}
        if self.clock is not None:
            out["virtual_now"] = round(self.clock(), 9)
        self._json(h, out)

    def _metrics(self, h, q) -> None:
        if q.get("view", [""])[0] == "fleet":
            text = self._read(
                lambda: aggregate(self.tel.metrics).exposition())
        else:
            text = self._read(lambda: self.tel.metrics.exposition())
        self._send(h, 200, text.encode(), _PROM_CTYPE)

    def _traces(self, h, q) -> None:
        clip = None
        if self.clock is not None and q.get("full", [""])[0] != "1":
            clip = self.clock()
        doc = self._read(
            lambda: obs_export.to_chrome(self.tel.trace, clip_at=clip))
        body = obs_export.dumps(doc).encode()
        self._send(h, 200, body, "application/json",
                   {"Content-Disposition":
                    'attachment; filename="trace.json"'})

    def _audit(self, h, path: str) -> None:
        au = self.tel.audit
        if path == "/audit":
            self._json(h, self._read(lambda: {
                "records": len(au.records), "links": len(au.links),
                "arrivals": len(au.arrivals),
                "dropped": {"records": au.dropped,
                            "links": au.dropped_links,
                            "arrivals": au.dropped_arrivals},
                "complete_programs": au.complete_programs()}))
            return
        pid = path[len("/audit/"):]
        chain = self._read(lambda: au.chain(pid))
        if not chain["records"] and not chain["links"]:
            self._json(h, {"error": f"unknown program {pid!r}"}, code=404)
            return
        self._json(h, chain)

    def _slo(self, h) -> None:
        if self.tel.slo is None:
            self._json(h, {"error": "slo monitor not enabled"}, code=404)
            return
        self._json(h, self._read(self.tel.slo.status))

    def _attribution(self, h, path: str) -> None:
        report = self._read(lambda: self.tel.attribution())
        if path == "/attribution":
            self._json(h, report)
            return
        pid = path[len("/attribution/"):]
        prog = report["programs"].get(pid)
        if prog is None:
            self._json(h, {"error": f"no completed program {pid!r}"},
                       code=404)
            return
        self._json(h, prog)

    def _drift(self, h) -> None:
        if self.tel.drift is None:
            self._json(h, {"error": "drift watchdog not enabled"}, code=404)
            return
        self._json(h, self._read(self.tel.drift.status))

    def _events(self, h, q) -> None:
        limit = int(q.get("limit", ["0"])[0])
        poll = float(q.get("poll", [str(self.poll_s)])[0])
        tr = self.tel.trace
        cursor = int(q.get("from", [str(tr.seq - len(tr.events))])[0])
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Connection", "close")
        h.end_headers()
        sent = 0
        while not self._stopping:
            events, new_cursor = self._read(lambda: tr.tail(cursor))
            base = new_cursor - len(events)
            if base > cursor:
                # the ring compacted past the cursor: announce exactly
                # what was lost instead of silently skipping ahead
                gap = json.dumps({"from": cursor + 1, "to": base,
                                  "dropped": base - cursor},
                                 separators=(",", ":"))
                h.wfile.write(f"event: gap\ndata: {gap}\n\n".encode())
            cursor = new_cursor
            for i, ev in enumerate(events):
                payload = json.dumps(ev, separators=(",", ":"))
                h.wfile.write(f"id: {base + i + 1}\n"
                              f"data: {payload}\n\n".encode())
                sent += 1
                if limit and sent >= limit:
                    h.wfile.flush()
                    return
            h.wfile.flush()
            if not events:
                h.wfile.write(b": keep-alive\n\n")
                h.wfile.flush()
                time.sleep(poll)
