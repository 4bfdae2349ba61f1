"""One-file stdlib Prometheus exporter: serve a ``.prom`` file over HTTP.

The soak driver writes its metrics file (``make soak`` ->
``BENCH_soak.prom``); this module serves it so a Prometheus scraper or
a browser can watch a long soak converge:

    make serve-metrics                  # BENCH_soak.prom on :9109
    PYTHONPATH=src python -m repro_torch.obs.exporter \
        --file BENCH_soak.prom --port 9109

``GET /metrics`` (and ``/``) returns the file's current content with
the text-exposition content type, re-read on every scrape so a running
soak's periodic dumps show up live.  404 on other paths, 503 when the
file does not exist yet.  Stdlib ``http.server`` only — no
prometheus_client dependency.
"""
from __future__ import annotations

import argparse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def make_handler(path: str):
    class MetricsHandler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path not in ("/", "/metrics"):
                self.send_error(404, "try /metrics")
                return
            try:
                with open(path, "rb") as f:
                    body = f.read()
            except OSError as e:
                self.send_error(503, f"metrics file not readable: {e}")
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet scrape log
            pass

    return MetricsHandler


def make_server(path: str, port: int = 9109,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Build (but do not run) the server; port 0 picks an ephemeral
    port — ``server.server_address[1]`` has the real one (tests use
    this)."""
    return ThreadingHTTPServer((host, port), make_handler(path))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--file", default="BENCH_soak.prom",
                    help="metrics file to serve (re-read per scrape)")
    ap.add_argument("--port", type=int, default=9109)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args()
    srv = make_server(args.file, args.port, args.host)
    host, port = srv.server_address[:2]
    print(f"serving {args.file} on http://{host}:{port}/metrics "
          f"(ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
