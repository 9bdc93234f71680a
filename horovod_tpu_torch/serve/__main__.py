"""CLI: ``python -m horovod_tpu_torch.serve`` (docs/serving.md).

Port of ``horovod_tpu/serve/__main__.py``: the same roles and flags, plus
``--device`` (replicas serve on the card unless it says ``cpu``).

Default topology — router in the foreground plus ``--np`` replica
subprocesses::

    python -m horovod_tpu_torch.serve --ckpt-dir /ckpts --model mnist_mlp \
        --np 2 --port 8000 --journal-dir /ckpts/serve

Restart a crashed router into its journaled routing table (replicas
keep serving through the outage and are rediscovered by heartbeat)::

    python -m horovod_tpu_torch.serve --role router --port 8000 \
        --journal-dir /ckpts/serve

Run one replica by hand (what the default topology spawns)::

    python -m horovod_tpu_torch.serve --role replica --ckpt-dir /ckpts \
        --model mnist_mlp --router 127.0.0.1:8000 --replica-id r0

Fleet operations (docs/serving.md#fleet-operations-runbook)::

    # hot standby: takes over port 8000 when the active router's
    # lease goes silent, replaying the shared journal
    python -m horovod_tpu_torch.serve --role standby --port 8000 \
        --journal-dir /ckpts/serve

    # rolling checkpoint upgrade to step 1200, two replicas per wave
    python -m horovod_tpu_torch.serve --role roll --port 8000 \
        --step 1200 --wave-size 2

    # gracefully drain one replica out of the fleet
    python -m horovod_tpu_torch.serve --role drain --port 8000 \
        --replica-id r0
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import os
import signal
import sys
import time


def _exit_gracefully_on_sigterm(stop_fn):
    """SIGTERM = operator-initiated shutdown: stop cleanly (close the
    journal, reap replica children). SIGKILL remains the crash path
    the journal exists for — replicas deliberately survive it."""

    def handler(signum, frame):
        stop_fn()
        sys.exit(0)

    signal.signal(signal.SIGTERM, handler)


def _default_port() -> int:
    try:
        return int(os.environ.get("HVD_SERVE_PORT", 8000))
    except ValueError:
        return 8000


def _router_addr(args):
    if args.router:
        addr, _, port = args.router.rpartition(":")
        return addr, int(port)
    return "127.0.0.1", args.port


def _post_json(addr, port, path, doc, timeout=30.0):
    conn = http.client.HTTPConnection(addr, port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(doc).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode() or "{}")
    finally:
        conn.close()


def _roll_main(args) -> int:
    """Operator CLI for the rolling upgrade: POST /v1/roll to the
    ACTIVE router (the controller must run in the journal-owning
    process so a failover can resume it), then poll status until the
    roll finishes. Exit 0 on ok, 1 on abort."""
    if args.step is None:
        print("--role roll needs --step (the target committed "
              "checkpoint step)", file=sys.stderr)
        return 2
    addr, port = _router_addr(args)
    doc = {"step": args.step}
    if args.wave_size is not None:
        doc["wave_size"] = args.wave_size
    if args.settle_sec is not None:
        doc["settle_sec"] = args.settle_sec
    status, payload = _post_json(addr, port, "/v1/roll", doc)
    if status != 202:
        print("roll refused (%d): %s" % (status, payload),
              file=sys.stderr)
        return 1
    from horovod_tpu_torch.serve.server import http_get_json

    while True:
        time.sleep(0.5)
        try:
            roll = http_get_json(addr, port, "/v1/roll", timeout=10)
        except OSError:
            # Router died mid-roll: a standby (if any) resumes from
            # the journal on the SAME port — keep polling.
            continue
        print("roll: wave=%s/%s outcome=%s"
              % (roll.get("wave"), roll.get("waves"),
                 roll.get("outcome")), flush=True)
        if roll.get("outcome") is not None:
            if roll.get("outcome") == "ok":
                return 0
            print("roll aborted: %s" % roll.get("reason"),
                  file=sys.stderr)
            return 1


def _drain_main(args) -> int:
    """Operator CLI: gracefully drain one replica via the router."""
    addr, port = _router_addr(args)
    status, payload = _post_json(addr, port, "/v1/drain",
                                 {"replica": args.replica_id})
    print(json.dumps(payload), flush=True)
    return 0 if status == 200 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve",
        description="Crash-safe micro-batching inference serving "
                    "(docs/serving.md)")
    ap.add_argument("--role",
                    choices=("serve", "router", "replica", "standby",
                             "roll", "drain"),
                    default="serve",
                    help="serve = router + --np replica subprocesses "
                         "(default); router = front door only (the "
                         "crash-restart path); replica = one worker; "
                         "standby = hot-standby router failover; "
                         "roll = rolling checkpoint upgrade to --step; "
                         "drain = gracefully drain --replica-id")
    ap.add_argument("--ckpt-dir", default=None,
                    help="Checkpointer directory holding the committed "
                         "steps to serve")
    ap.add_argument("--model", default="mnist_mlp",
                    help="registered model name (or 'identity' for the "
                         "jax-free passthrough the bench uses)")
    ap.add_argument("--np", type=int, default=1, dest="np_",
                    help="replica worker subprocesses to spawn")
    ap.add_argument("--port", type=int, default=None,
                    help="router bind port (default HVD_SERVE_PORT or "
                         "8000; replicas default to an ephemeral port)")
    ap.add_argument("--journal-dir", default=None,
                    help="serve journal directory (default: "
                         "<ckpt-dir>/serve_journal when --ckpt-dir is "
                         "given); the router's crash-safe routing table")
    ap.add_argument("--liveness-sec", type=float, default=None,
                    help="cull replicas silent this long (default "
                         "HOROVOD_WORKER_LIVENESS_SEC or 30)")
    ap.add_argument("--device", default=None,
                    help="where replicas run the model: cuda (the "
                         "default; cuda:N for card N) or cpu")
    # replica-role flags
    ap.add_argument("--router", default=None,
                    help="[replica] router addr:port to register with")
    ap.add_argument("--replica-id", default="r0",
                    help="[replica] stable replica identity; "
                         "[drain] the replica to drain")
    # fleet-operations flags
    ap.add_argument("--step", type=int, default=None,
                    help="[roll] target committed checkpoint step")
    ap.add_argument("--wave-size", type=int, default=None,
                    help="[roll] replicas upgraded per wave (default "
                         "HVD_SERVE_ROLL_WAVE or 1)")
    ap.add_argument("--settle-sec", type=float, default=None,
                    help="[roll] per-wave health-gate window (default "
                         "HVD_SERVE_ROLL_SETTLE_SEC or 1)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.role == "replica":
        from horovod_tpu_torch.serve import replica as _replica

        if args.port is None:
            args.port = 0
        return _replica.main(args)

    if args.port is None:
        args.port = _default_port()
    if args.journal_dir is None and args.ckpt_dir:
        args.journal_dir = os.path.join(args.ckpt_dir, "serve_journal")
    if args.journal_dir and "HVD_FLIGHTREC_DIR" not in os.environ:
        # Keep the control-plane process's own flight-record dumps
        # next to the journal instead of littering the cwd (the
        # replica children get their per-replica dirs from Server).
        os.environ["HVD_FLIGHTREC_DIR"] = os.path.join(
            args.journal_dir, "flightrec", args.role)

    if args.role == "roll":
        return _roll_main(args)
    if args.role == "drain":
        return _drain_main(args)

    if args.role == "standby":
        if not args.journal_dir:
            ap.error("--role standby needs --journal-dir (or "
                     "--ckpt-dir) — the shared journal IS the state "
                     "it takes over")
        from horovod_tpu_torch.serve.standby import Standby

        standby = Standby(journal_dir=args.journal_dir, port=args.port,
                          liveness_sec=args.liveness_sec)
        standby.start()
        _exit_gracefully_on_sigterm(standby.stop)
        print("SERVE_STANDBY_READY port=%d pid=%d"
              % (args.port, os.getpid()), flush=True)
        try:
            while True:
                if standby.wait_takeover(3600):
                    if standby.router is not None:
                        print("SERVE_STANDBY_TOOK_OVER port=%d pid=%d "
                              "replayed=%d"
                              % (args.port, os.getpid(),
                                 standby.router._replayed), flush=True)
                    break
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            standby.stop()
        return 0

    if args.role == "router":
        from horovod_tpu_torch.serve.router import Router

        router = Router(port=args.port, journal_dir=args.journal_dir,
                        liveness_sec=args.liveness_sec)
        port = router.start()
        _exit_gracefully_on_sigterm(router.stop)
        print("SERVE_ROUTER_READY port=%d pid=%d replayed=%d"
              % (port, os.getpid(), router._replayed), flush=True)
        # A restarted router picks an interrupted rolling upgrade back
        # up from the journal — same resume path the standby uses.
        resumed = router.resume_roll_if_pending()
        if resumed is not None:
            print("SERVE_ROLL_RESUMED %s"
                  % json.dumps(resumed.get("status") or {}), flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            router.stop()
        return 0

    from horovod_tpu_torch.serve.server import Server

    server = Server(ckpt_dir=args.ckpt_dir, model=args.model,
                    num_replicas=args.np_, port=args.port,
                    journal_dir=args.journal_dir,
                    liveness_sec=args.liveness_sec, device=args.device)
    port = server.start()
    _exit_gracefully_on_sigterm(server.stop)
    print("SERVE_ROUTER_READY port=%d pid=%d replicas=%d"
          % (port, os.getpid(), args.np_), flush=True)
    try:
        server.wait_ready()
        print("SERVE_FLEET_READY port=%d" % port, flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    except Exception:
        # Startup failure (replica crashed on load, ready timeout):
        # reap the already-spawned replica children before dying —
        # leaving them serving is the contract for a router CRASH
        # (SIGKILL), not for a failed launch.
        server.stop()
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
