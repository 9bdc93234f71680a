"""Client of the elastic driver's rendezvous KV store.

Port of the client half of ``horovod_tpu/runner/http_server.py``
(``read_kv`` :428, ``write_kv`` :445, ``put_kv`` :452). The store speaks
plain HTTP: ``GET``/``PUT /<scope>/<key>``. A bounded store sheds a request
with a typed 503 and a ``Retry-After`` header, which ``put_kv`` returns
instead of raising.
"""

from __future__ import annotations

import http.client
from typing import Optional, Tuple


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
