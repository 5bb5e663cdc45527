"""pgr-server on the port: an HTTP service over a SeqIndexDB — the
counterpart of pgrtk_tpu/server/main.py (reference:
pgr-web/pgr-server/src/main.rs).

    python -m pgrtk_tpu_torch.server.main DB_PREFIX [--frg-file] [--addr 127.0.0.1] [--port 3000] [--static-dir DIR] [--rois-json FILE] [--device cuda]

Routes (the reference axum server's paths):
  GET  /api/version                      the port's library version
  GET  /api/get_number_of_ctgs
  POST /api/post_query_for_json_data    body: SequenceQuerySpec JSON
  GET  /api/get_html_by_query?<url-encoded SequenceQuerySpec JSON>
  GET  /api/get_rois                     (the whole ROI preset map)
  GET  /ws                               (RFC 6455 websocket: the client
                                          sends a name prefix, the server
                                          answers the matching ROI map —
                                          pgr-server/src/main.rs:209-255)
  static files from --static-dir with an index.html fallback

stdlib http.server; CORS is wide open like the reference's
CorsLayer::new().allow_origin(Any).  A ThreadingHTTPServer shares one
facade across handler threads (its lazy caches fill under a lock).  A
query route answers 400 with {"error": ...} on any exception, as the JAX
server does.  `--device` (the port's own option, "cuda" by default)
places the query and each request's decomposition; the version header
and /api/version give the port's bindings.pgr_lib_version().
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..api import SeqIndexDB
from ..bindings import pgr_lib_version
from .bundle_processing import (SequenceQuerySpec,
                                get_target_and_principal_bundle_decomposition,
                                pb_data_to_html_string)

log = logging.getLogger("pgrtk_tpu_torch")


def init_cli_logging(level=logging.INFO):
    """Attach a stderr handler to the pgrtk_tpu_torch logger for a CLI
    run (PGRTK_LOG=debug|quiet overrides; pgrtk_tpu/utils/dispatch.py:
    26-41).  Library users configure logging themselves."""
    env = os.environ.get("PGRTK_LOG", "").lower()
    if env == "quiet":
        return
    if env == "debug":
        level = logging.DEBUG
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "[%(asctime)s pgrtk_tpu_torch] %(message)s", "%H:%M:%S"))
        log.addHandler(h)
    log.setLevel(level)


class Handler(BaseHTTPRequestHandler):
    """The routes over the class's `seq_db`, on its `device`.  `stats`,
    when a dict, receives each request's stage seconds under "seconds"
    (fetch, query, in-memory index, decomposition, JSON): for serial
    requests only, since the handlers share it."""

    seq_db: SeqIndexDB = None
    device = "cuda"
    static_dir: str = "."
    rois: list = []
    stats = None

    def _send(self, code, body, ctype="application/json"):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "*")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("X-Pgrtk-Version", pgr_lib_version())
        self.end_headers()
        self.wfile.write(data)
        self._status = code

    def handle_one_request(self):
        # request tracing (the reference's tower-http TraceLayer,
        # pgr-web/pgr-server/src/main.rs:116): method, path, status, ms
        self._status = None
        t0 = time.monotonic()
        super().handle_one_request()
        if getattr(self, "command", None) and self._status is not None:
            log.info("%s %s -> %d (%.1f ms)", self.command, self.path,
                     self._status, 1e3 * (time.monotonic() - t0))

    def _decompose(self, spec_json):
        spec = SequenceQuerySpec(**json.loads(spec_json))
        return get_target_and_principal_bundle_decomposition(
            spec, self.seq_db, device=self.device, stats=self.stats)

    def _timed(self, fn):
        t = time.perf_counter()
        out = fn()
        if self.stats is not None:
            sec = self.stats.setdefault("seconds", {})
            sec["JSON"] = sec.get("JSON", 0.0) + time.perf_counter() - t
        return out

    def do_OPTIONS(self):
        self._send(200, "")

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/api/version":
            self._send(200, json.dumps(pgr_lib_version()))
        elif parsed.path == "/api/get_number_of_ctgs":
            self._send(200, json.dumps(len(self.seq_db.seq_info)))
        elif parsed.path == "/api/get_html_by_query":
            try:
                targets = self._decompose(urllib.parse.unquote(parsed.query))
                html = self._timed(lambda: pb_data_to_html_string(targets))
                self._send(200, html, "text/html")
            except Exception as e:  # noqa: BLE001
                self._send(400, json.dumps({"error": str(e)}))
        elif parsed.path == "/api/get_rois":
            self._send(200, json.dumps(self.rois))
        elif parsed.path == "/ws" and (
                self.headers.get("Upgrade", "").lower() == "websocket"):
            self._handle_ws()
        else:
            self._serve_static(parsed.path)

    def _handle_ws(self):
        """ROI autocomplete over websocket (reference protocol,
        pgr-web/pgr-server/src/main.rs:209-255): text message = name
        prefix; reply = JSON object of ROI entries whose name starts
        with it; empty message -> {}."""
        from . import ws

        if not ws.handshake(self):
            self._send(400, json.dumps({"error": "bad websocket request"}))
            return
        self._status = 101
        self.close_connection = True
        rois = self.rois if isinstance(self.rois, dict) else {}

        def respond(prefix: str) -> str:
            if not prefix:
                return "{}"
            keys = sorted(k for k in rois if k.startswith(prefix))
            return json.dumps({k: rois[k] for k in keys})

        try:
            ws.serve_text(self, respond)
        except (OSError, ValueError):
            pass  # client went away mid-frame

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/api/post_query_for_json_data":
            try:
                n = int(self.headers.get("Content-Length", 0))
                targets = self._decompose(self.rfile.read(n))
                self._send(200, self._timed(lambda: json.dumps(targets)))
            except Exception as e:  # noqa: BLE001
                self._send(400, json.dumps({"error": str(e)}))
        else:
            self._send(404, json.dumps({"error": "not found"}))

    def _serve_static(self, path):
        rel = path.lstrip("/") or "index.html"
        full = os.path.normpath(os.path.join(self.static_dir, rel))
        if not full.startswith(os.path.normpath(self.static_dir)):
            self._send(404, "not found", "text/plain")
            return
        if not os.path.isfile(full):
            full = os.path.join(self.static_dir, "index.html")
            if not os.path.isfile(full):
                self._send(404, "index file not found", "text/plain")
                return
        ctype = "text/html"
        if full.endswith(".js"):
            ctype = "application/javascript"
        elif full.endswith(".css"):
            ctype = "text/css"
        elif full.endswith(".json"):
            ctype = "application/json"
        with open(full, "rb") as f:
            self._send(200, f.read(), ctype)

    def log_message(self, fmt, *args):  # quieter default logging
        sys.stderr.write("%s - %s\n" % (self.address_string(), fmt % args))


def make_server(argv=None) -> ThreadingHTTPServer:
    """Parse pgr-server's options, load the index on the handler class
    and bind the server (not yet serving)."""
    p = argparse.ArgumentParser(prog="pgr-server")
    p.add_argument("data_path_prefix")
    p.add_argument("--frg-file", action="store_true")
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--static-dir", default="./dist")
    p.add_argument("--rois-json", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the queries and decompositions")
    args = p.parse_args(argv)
    log.info("starting %s", pgr_lib_version())

    db = SeqIndexDB(device=args.device)
    if args.frg_file:
        db.load_from_frg_index(args.data_path_prefix)
    else:
        db.load_from_agc_index(args.data_path_prefix)

    Handler.seq_db = db
    Handler.device = args.device
    Handler.static_dir = args.static_dir
    if args.rois_json:
        with open(args.rois_json) as f:
            Handler.rois = json.load(f)
    return ThreadingHTTPServer((args.addr, args.port), Handler)


def main(argv=None):
    init_cli_logging()
    server = make_server(argv)
    addr, port = server.server_address[:2]
    print(f"listening on {addr}:{port}")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
