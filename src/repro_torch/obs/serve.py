"""In-run HTTP scrape endpoint for the observability plane.

A stdlib ``ThreadingHTTPServer`` on a daemon thread serving the live
registry while ticks are in flight:

- ``/metrics`` and ``/metrics.prom`` — Prometheus text exposition
  (``text/plain; version=0.0.4``).
- ``/metrics.json`` and ``/snapshot`` — the versioned JSON snapshot
  (schema v2: counters/gauges/histograms + sampling metadata + exemplar
  timelines).
- ``/healthz`` — liveness probe (``ok``).

Consistency: both renderers go through ``Obs.snapshot()`` /
``MetricsRegistry.to_prometheus()``, which hold the registry lock while
iterating, so a scrape never observes a torn instrument table and exact
counters are monotone non-decreasing across scrapes.  Port 0 binds an
ephemeral port; the bound port is exposed as ``ObsServer.port``.

The server is deliberately tiny: no auth, no TLS, bound to localhost by
default — it is a development/CI scrape surface, not a public API.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"
_JSON_CTYPE = "application/json"


class ObsServer:
    """Threaded scrape endpoint over one ``Obs`` instance."""

    def __init__(self, obs, port: int = 0, host: str = "127.0.0.1"):
        self.obs = obs
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # silence per-request stderr logging (scrapes are hot-path)
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/metrics", "/metrics.prom"):
                        body = outer.obs.to_prometheus().encode()
                        self._reply(200, body, _PROM_CTYPE)
                    elif path in ("/metrics.json", "/snapshot"):
                        body = json.dumps(outer.obs.snapshot(),
                                          default=repr).encode()
                        self._reply(200, body, _JSON_CTYPE)
                    elif path == "/healthz":
                        self._reply(200, b"ok\n", "text/plain")
                    else:
                        self._reply(404, b"not found\n", "text/plain")
                except (BrokenPipeError, ConnectionResetError):
                    pass               # scraper went away mid-reply

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObsServer":
        t = threading.Thread(target=self._httpd.serve_forever,
                             kwargs={"poll_interval": 0.1},
                             name=f"obs-serve-{self.port}", daemon=True)
        t.start()
        self._thread = t
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
