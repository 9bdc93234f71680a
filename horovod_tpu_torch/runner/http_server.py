"""The metrics server and the client of the elastic driver's KV store.

Port of ``horovod_tpu/runner/http_server.py``: ``KVStoreServer`` (:319)
with its handler (``_KVHandler`` :72) and bounded server
(``_BoundedHTTPServer`` :237), ``json_route_result`` (:64) and the
server's own ``hvd_kv_*`` families (:47-58), and the client half
(``read_kv`` :428, ``write_kv`` :445, ``put_kv`` :452).

The server is a threaded HTTP store of ``GET``/``PUT``/``DELETE
/<scope>/<key>``; ``GET /metrics`` and ``/metrics.json`` serve the
process-wide registry (``utils/metrics.py``), and exact-path routes mount
through ``register_get_route``/``register_post_route``. A server made
with ``metrics_only=True`` (``hvd.start_metrics_server``) refuses the
write verbs. With ``HVD_KV_MAX_INFLIGHT`` > 0 it bounds its handler
threads and sheds the excess with a typed 503 and ``Retry-After``, which
``put_kv`` returns instead of raising. The elastic driver's
``RendezvousServer`` is not ported yet.
"""

from __future__ import annotations

import http.client
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from horovod_tpu_torch.common.util import float_env, int_env
from horovod_tpu_torch.utils import metrics as _metrics

_M_KV_SHED = _metrics.counter(
    "hvd_kv_requests_shed_total",
    "KV/HTTP connections shed with a typed 503 + Retry-After because "
    "HVD_KV_MAX_INFLIGHT handler threads were already busy (heartbeat "
    "fan-in admission control; docs/fleet.md).")
_G_KV_INFLIGHT = _metrics.gauge(
    "hvd_kv_inflight_requests",
    "Handler threads currently serving KV/HTTP requests on a bounded "
    "server (HVD_KV_MAX_INFLIGHT > 0) — the KV queue-depth signal; "
    "pinned at the limit means the server is saturated and shedding.")

# A mounted route returns (status, content_type, body_bytes).
RouteResult = Tuple[int, str, bytes]


def json_route_result(status: int, payload: dict) -> RouteResult:
    """The one JSON-response builder every mounted route shares."""
    import json

    return (status, "application/json",
            (json.dumps(payload) + "\n").encode())


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _count_request(self):
        """Bump the server's served-request counter (the fleet O(N)
        guards count KV traffic per driver cycle against it)."""
        server = self.server
        with server.count_lock:
            server.requests_total += 1

    def _split(self) -> Tuple[str, str]:
        parts = self.path.strip("/").split("/", 1)
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return scope, key

    def _serve_metrics(self, as_json: bool):
        """Prometheus text (or JSON snapshot) of the process-wide
        metrics registry (docs/metrics.md). Routed before the KV scopes
        so 'metrics' can never collide with a store scope."""
        try:
            from horovod_tpu_torch.utils import metrics

            if as_json:
                body = metrics.render_json().encode()
                ctype = "application/json"
            else:
                body = metrics.render_prometheus().encode()
                ctype = metrics.PROMETHEUS_CONTENT_TYPE
        except Exception as e:  # a broken registry must not kill the server
            body = ("metrics export failed: %s\n" % e).encode()
            self.send_response(500)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _run_route(self, route, *args):
        """Invoke a mounted route with a last-resort 500 guard: an
        exception escaping the handler would otherwise drop the
        connection with no status line at all — the client deserves a
        labeled failure it can react to. The unpack happens INSIDE the
        guard so a malformed return value (None, wrong arity) gets the
        same labeled 500 as a raise."""
        try:
            status, ctype, body = route(*args)
        except Exception as e:  # noqa: BLE001 — a route's bug is a 500
            # on this request; the server keeps serving.
            status, ctype, body = (
                500, "text/plain; charset=utf-8",
                ("route handler failed: %s\n" % e).encode())
        self._send_route_result((status, ctype, body))

    def _send_route_result(self, result: RouteResult):
        status, ctype, body = result
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._count_request()
        path = self.path.split("?", 1)[0].rstrip("/")
        route = getattr(self.server, "get_routes", {}).get(path or "/")
        if route is not None:
            self._run_route(route)
            return
        if path == "/metrics":
            self._serve_metrics(as_json=False)
            return
        if path == "/metrics.json":
            self._serve_metrics(as_json=True)
            return
        scope, key = self._split()
        store = self.server.store
        with self.server.lock:
            value = store.get(scope, {}).get(key)
        if value is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def _reject_write_if_metrics_only(self) -> bool:
        """A server advertised as a metrics scrape target must not also
        be an unauthenticated writable KV store: on metrics-only
        servers the write verbs are refused."""
        if not getattr(self.server, "metrics_only", False):
            return False
        length = int(self.headers.get("Content-Length", 0))
        if length:
            self.rfile.read(length)
        self.send_response(405)
        self.send_header("Allow", "GET")
        self.send_header("Content-Length", "0")
        self.end_headers()
        return True

    def do_POST(self):
        self._count_request()
        path = self.path.split("?", 1)[0].rstrip("/")
        route = getattr(self.server, "post_routes", {}).get(path or "/")
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        if route is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self._run_route(route, body)

    def do_PUT(self):
        self._count_request()
        if self._reject_write_if_metrics_only():
            return
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        with self.server.lock:
            self.server.store.setdefault(scope, {})[key] = value
        callback = getattr(self.server, "put_callback", None)
        if callback:
            # Handler threads run concurrently; serializing the callback
            # here means consumers (driver heartbeat stamping, serve
            # router admission journaling) need no locking of their own.
            with self.server.callback_lock:
                callback(scope, key, value)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):
        self._count_request()
        if self._reject_write_if_metrics_only():
            return
        scope, key = self._split()
        with self.server.lock:
            self.server.store.get(scope, {}).pop(key, None)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, fmt, *args):  # quiet
        pass


class _BoundedHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a bounded handler pool.

    ``max_inflight`` <= 0 is the legacy thread-per-connection server.
    Above 0, a connection arriving while ``max_inflight`` handler
    threads are busy is shed ON THE ACCEPT THREAD with a canned
    ``503`` + ``Retry-After`` — a tiny fixed-cost write, so admission
    stays O(1) no matter how deep the storm — instead of spawning a
    thread that will fight 499 others for the callback lock."""

    max_inflight = 0
    retry_after_sec = 1.0
    # socketserver's default listen backlog is 5: at fleet cardinality
    # (hundreds of heartbeat connections per second) the SYN queue
    # overflows and clients eat kernel SYN-retransmit stalls — a ~1s
    # p99 cliff with no server-side signal at all. A deep backlog
    # keeps admission decisions OURS (shed with a typed 503), not the
    # kernel's (silent retransmit).
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Served (not shed) HTTP requests, all verbs. Exposed as
        # KVStoreServer.requests_total for the fleet O(N) guards.
        self.requests_total = 0
        self.count_lock = threading.Lock()

    def process_request(self, request, client_address):
        if self.max_inflight > 0:
            with self._inflight_lock:
                shed = self._inflight >= self.max_inflight
                if not shed:
                    self._inflight += 1
                    _G_KV_INFLIGHT.set(self._inflight)
            if shed:
                self._shed_request(request)
                return
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            if self.max_inflight > 0:
                with self._inflight_lock:
                    self._inflight -= 1
                    _G_KV_INFLIGHT.set(self._inflight)

    def _shed_request(self, request):
        from horovod_tpu_torch.utils import flightrec

        _M_KV_SHED.inc()
        flightrec.record("kv_shed", limit=self.max_inflight)
        try:
            request.sendall(
                ("HTTP/1.1 503 Service Unavailable\r\n"
                 "Retry-After: %g\r\n"
                 "Content-Length: 0\r\n"
                 "Connection: close\r\n\r\n"
                 % self.retry_after_sec).encode())
            # Lingering close: the peer is mid-sendall on its request
            # body, and close() with unread inbound bytes turns into an
            # RST that destroys the 503 sitting in the peer's receive
            # buffer (it sees EPIPE/ECONNRESET, not the typed shed).
            # Half-close our write side so the response + FIN land,
            # then drain what the peer sends until EOF — bounded in
            # both time and bytes so a wedged peer cannot hold the
            # accept thread.
            request.shutdown(socket.SHUT_WR)
            request.settimeout(0.25)
            drained = 0
            while drained < 65536:
                chunk = request.recv(8192)
                if not chunk:
                    break
                drained += len(chunk)
        except OSError:
            pass  # the storm peer vanished first; the shed still counts
        self.shutdown_request(request)


class KVStoreServer:
    """In-process threaded HTTP KV store."""

    def __init__(self, port: int = 0, put_callback=None,
                 metrics_only: bool = False,
                 max_inflight: Optional[int] = None):
        self._httpd = _BoundedHTTPServer(("0.0.0.0", port), _KVHandler)
        if max_inflight is None:
            max_inflight = int_env("HVD_KV_MAX_INFLIGHT", 0)
        self._httpd.max_inflight = int(max_inflight)
        self._httpd.retry_after_sec = max(
            0.05, float_env("HVD_KV_RETRY_AFTER_SEC", 1.0))
        self._httpd.store = {}
        self._httpd.lock = threading.Lock()
        self._httpd.put_callback = put_callback
        self._httpd.callback_lock = threading.Lock()
        self._httpd.get_routes = {}
        self._httpd.post_routes = {}
        # Refuse HTTP writes: hvd.start_metrics_server() exposes this
        # port to scrapers, which must not get a writable KV store.
        self._httpd.metrics_only = metrics_only
        self._thread: Optional[threading.Thread] = None

    def register_get_route(self, path: str,
                           fn: Callable[[], RouteResult]):
        """Mount an exact-path GET handler (matched before the KV
        scopes and the /metrics routes). ``fn() -> (status, content
        type, body bytes)`` runs on the connection's handler thread."""
        self._httpd.get_routes[path.rstrip("/") or "/"] = fn

    def register_post_route(self, path: str,
                            fn: Callable[[bytes], RouteResult]):
        """Mount an exact-path POST handler; ``fn(request_body)`` runs
        on the connection's handler thread, concurrently with other
        requests — it must not assume exclusivity."""
        self._httpd.post_routes[path.rstrip("/") or "/"] = fn

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvd-kvstore")
        self._thread.start()
        return self.port

    def stop(self):
        # shutdown() blocks until serve_forever() acknowledges — on a
        # never-started server that loop does not exist and the call
        # would hang forever, so only signal a loop that is running.
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()

    @property
    def requests_total(self) -> int:
        """HTTP requests this server actually handled (shed
        connections excluded — those never reach a handler)."""
        with self._httpd.count_lock:
            return self._httpd.requests_total

    # Direct access helpers for in-process users (the driver).
    def get(self, scope: str, key: str) -> Optional[bytes]:
        with self._httpd.lock:
            return self._httpd.store.get(scope, {}).get(key)

    def put(self, scope: str, key: str, value: bytes):
        with self._httpd.lock:
            self._httpd.store.setdefault(scope, {})[key] = value

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        with self._httpd.lock:
            return dict(self._httpd.store.get(scope, {}))

    def clear_scope(self, scope: str):
        with self._httpd.lock:
            self._httpd.store.pop(scope, None)


def read_kv(addr: str, port: int, scope: str, key: str,
            timeout: float = 10.0) -> Optional[bytes]:
    """The value of ``scope/key``, or None when the store has none."""
    conn = http.client.HTTPConnection(addr, port, timeout=timeout)
    try:
        conn.request("GET", "/%s/%s" % (scope, key))
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            return None
        return data
    finally:
        conn.close()


def write_kv(addr: str, port: int, scope: str, key: str, value: bytes,
             timeout: float = 10.0) -> int:
    """PUT one key; returns the HTTP status (200, or 503 when a bounded
    server shed the request)."""
    return put_kv(addr, port, scope, key, value, timeout=timeout)[0]


def put_kv(addr: str, port: int, scope: str, key: str, value: bytes,
           timeout: float = 10.0) -> Tuple[int, float]:
    """PUT one key against a possibly bounded server: returns ``(status,
    retry_after_sec)``. ``retry_after_sec`` is 0 unless the server shed
    the request with a typed 503; then it is the server's requested
    deferral, and a heartbeat should wait that long (plus jitter) rather
    than retry into the same storm."""
    conn = http.client.HTTPConnection(addr, port, timeout=timeout)
    try:
        try:
            conn.request("PUT", "/%s/%s" % (scope, key), body=value)
        except (BrokenPipeError, ConnectionResetError):
            # A bounded server that sheds us half-closes its write side as
            # soon as it decides, and our body's sendall can lose that
            # race. The typed 503 is usually already in our receive
            # buffer: read it instead of surfacing a transport error.
            pass
        resp = conn.getresponse()
        resp.read()
        retry_after = 0.0
        if resp.status == 503:
            try:
                retry_after = float(resp.getheader("Retry-After") or 0.0)
            except ValueError:
                retry_after = 0.0
        return resp.status, retry_after
    finally:
        conn.close()
