"""Replica worker: checkpoint -> model on the card -> HTTP predict shard.

Port of ``horovod_tpu/serve/replica.py``. One replica process serves one
shard of the replica pool: it loads the newest *committed* checkpoint
through the port's ``utils/checkpoint.Checkpointer`` (torch files, the
same commit discipline training used, so a replica can never load a
half-written step), runs the model in eval mode under
``torch.inference_mode()`` on its device (the card unless
``device="cpu"``), and answers ``POST /v1/predict`` behind the
micro-batching queue (``serve/batching.py``). Requests carry the
reference's row shapes (MNIST rows (28, 28) for the MLP, NHWC (28, 28, 1)
for the CNN), so a client speaks to either package alike.

Row bit-equality (``batching.assert_bucket_equality``, run before the
replica admits traffic): a row's output must be the same bits in every
bucket and beside any co-batched rows. cuBLAS and cuDNN may choose
another algorithm by the number of rows, so on the card the replica
turns TF32 off, makes cuDNN deterministic with its benchmark off, and
pins cuBLAS's workspace (``CUBLAS_WORKSPACE_CONFIG``); with these the
check holds on the H100 for the MNIST models at every bucket and row
position.

Crash-safety wiring (the elastic machinery, reused):

- the replica PUTs ``heartbeat/<replica_id>`` to the router's KV every
  ``HVD_HEARTBEAT_SEC`` (the exact discipline elastic workers use);
  the heartbeat payload carries the replica's endpoint, so a restarted
  router — or one that culled this replica during a stall — re-admits
  it from the next beat alone;
- registration/heartbeat failures are logged and retried forever: the
  router being down (mid-restart) must not kill a healthy replica.

Checkpoint hot-reload: every ``HVD_SERVE_CKPT_POLL_SEC`` the replica
polls ``Checkpointer.latest_step()`` and atomically swaps in a newer
committed step — a training job can keep publishing checkpoints into
the directory a live serving fleet reads from. ``POST /v1/reload
{"step": N}`` is the directed form the rolling-upgrade controller
uses (serve/rollout.py): restore EXACTLY step N — downgrades included,
that is the rollback path — re-run the bucket self-check (compile
warmup), swap.

Graceful drain (``begin_drain``: SIGTERM, ``POST /v1/drain``, or the
router relaying an operator drain): flag ``draining`` in the
heartbeat payload immediately (the router benches this replica), 503
NEW predicts (the router retries them elsewhere — zero client-visible
loss), finish every queued micro-batch, send one final *goodbye* beat
(the router culls without waiting out the liveness window), exit 0.
"""

from __future__ import annotations

import json
import logging
import os
import random
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from horovod_tpu_torch.common.util import float_env, int_env
from horovod_tpu_torch.runner.http_server import (
    KVStoreServer,
    json_route_result,
    write_kv,
)
from horovod_tpu_torch.serve import batching
from horovod_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch")

_C_RELOADS = _metrics.counter(
    "hvd_serve_ckpt_reloads_total",
    "Newer committed checkpoint steps a serving replica hot-swapped in.")
# The serving replica rides the elastic heartbeat discipline wholesale,
# including its counter family (same KV scope, same cadence knob).
_C_HEARTBEATS = _metrics.counter(
    "hvd_elastic_heartbeats_total",
    "Liveness heartbeats this worker PUT to the rendezvous KV "
    "(heartbeat/<slot_key>, every HVD_HEARTBEAT_SEC).")

class _SteppedOutput(np.ndarray):
    """Batch output tagged with the checkpoint step that produced it.
    ``__array_finalize__`` propagates the tag through the batcher's
    per-request slices, so every future's result knows its true step
    even when a hot reload lands mid-flight."""

    step = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self.step = getattr(obj, "step", None)


# Model registry: name -> (builder, sample input shape, layout). The
# builder takes ``device=`` and returns an ``nn.Module``; ``layout``
# turns a batch of rows in the reference's shape into the module's input
# (the CNN takes NCHW). ``identity`` is the numpy passthrough the bench
# harness uses to measure the serving plane without a model.
_MODELS: Dict[str, Optional[Tuple[Callable[..., Any], Tuple[int, ...],
                                  Callable[[Any], Any]]]] = {
    "identity": None,
}


def _register_models():
    from horovod_tpu_torch.models import MnistCNN, MnistMLP

    _MODELS.setdefault("mnist_mlp", (MnistMLP, (28, 28), lambda x: x))
    _MODELS.setdefault("mnist_cnn", (MnistCNN, (28, 28, 1),
                                     lambda x: x.permute(0, 3, 1, 2)))


def row_stable_backends() -> None:
    """The ordinary remedies for row bit-equality on the card: no TF32,
    deterministic cuDNN with its benchmark off, and cuBLAS's workspace
    pinned (effective when set before cuBLAS starts: a replica process
    calls this before its first GEMM)."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def model_names():
    return sorted(set(_MODELS) | {"mnist_mlp", "mnist_cnn"})


class Replica:
    """One serving shard: load -> self-check -> serve.

    Library use::

        r = Replica(ckpt_dir=..., model="mnist_mlp",
                    router="127.0.0.1:8000", replica_id="r0")
        r.start()          # loads, self-checks, serves, heartbeats
        ...
        r.stop()

    A custom model plugs in with ``apply_fn`` (params, padded batch ->
    batch of outputs) plus ``sample_shape``; the registry covers the
    repo models. ``device`` is where the model runs: the card unless
    ``"cpu"``.
    """

    def __init__(self, model: str = "mnist_mlp",
                 ckpt_dir: Optional[str] = None,
                 router: Optional[str] = None,
                 replica_id: str = "r0",
                 port: int = 0,
                 advertise_addr: Optional[str] = None,
                 apply_fn: Optional[Callable] = None,
                 sample_shape: Optional[Tuple[int, ...]] = None,
                 max_batch: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 min_bucket: Optional[int] = None,
                 device: Optional[str] = None):
        self.model = model
        self.device = device or "cuda"
        self.ckpt_dir = ckpt_dir
        self.replica_id = replica_id
        self.router = router
        self._requested_port = port
        self.advertise_addr = advertise_addr or os.environ.get(
            "HOROVOD_HOSTNAME") or "127.0.0.1"
        self._user_apply = apply_fn
        self.sample_shape = sample_shape
        self._batcher_cfg = dict(max_batch=max_batch,
                                 deadline_ms=deadline_ms,
                                 min_bucket=min_bucket)
        self.step: Optional[int] = None
        self._apply_lock = threading.Lock()
        self._apply: Optional[Callable[[np.ndarray], np.ndarray]] = None
        self._ckpt = None
        self._batcher: Optional[batching.MicroBatcher] = None
        self._server: Optional[KVStoreServer] = None
        self._stop = threading.Event()
        self._threads = []
        self._draining = False
        self._drain_lock = threading.Lock()
        # Serializes directed reloads (/v1/reload) against each other
        # and the poller's own restores; the apply swap itself stays
        # under _apply_lock as before.
        self._reload_lock = threading.Lock()

    # --- model loading ------------------------------------------------------

    def _buckets(self):
        return batching.bucket_sizes(
            self._batcher_cfg["max_batch"]
            or int_env("HVD_SERVE_MAX_BATCH", 8),
            self._batcher_cfg["min_bucket"]
            or int_env("HVD_SERVE_MIN_BUCKET", 4))

    def _build_apply(self, params) -> Callable[[np.ndarray], np.ndarray]:
        """A new module in eval mode on ``self.device`` with ``params`` (a
        state dict) loaded, so that a reload never touches the module in
        service; a batch runs under ``inference_mode``."""
        import torch

        if torch.device(self.device).type == "cuda":
            row_stable_backends()
        module = self._builder(device=self.device)
        module.load_state_dict(params)
        module.eval()
        layout, device = self._layout, self.device

        def run(x: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
                return module(layout(xt)).float().cpu().numpy()

        return run

    def load(self):
        """Restore the newest committed step and build the bucketed,
        self-checked apply path. Identity model skips torch entirely."""
        if self.model == "identity":
            # Numpy passthrough, any row shape: the bench harness's
            # model-free stand-in for measuring the serving plane.
            with self._apply_lock:
                self._apply = lambda x: x
                self.step = -1
            self._start_batcher()
            return
        _register_models()
        if self._user_apply is not None:
            if self.sample_shape is None:
                raise ValueError("apply_fn needs sample_shape")
        else:
            if self.model not in _MODELS or _MODELS[self.model] is None:
                raise ValueError("unknown model %r (have: %s)"
                                 % (self.model, ", ".join(model_names())))
            self._builder, shape, self._layout = _MODELS[self.model]
            if self.sample_shape is None:
                self.sample_shape = shape
        if self.ckpt_dir is None:
            raise ValueError("model %r needs --ckpt-dir" % self.model)
        from horovod_tpu_torch.utils.checkpoint import Checkpointer

        self._ckpt = Checkpointer(self.ckpt_dir)
        self._restore_step(None)
        self._start_batcher()

    def _restore_step(self, step: Optional[int]):
        if step is None:
            # Resolve the step BEFORE restoring and pass it explicitly:
            # a checkpoint committed between restore() and a later
            # latest_step() query would mislabel self.step above the
            # params actually loaded, and the hot-reload poll
            # (latest > self.step) would then skip that step forever.
            step = self._ckpt.latest_step()
        restored = self._ckpt.restore(step=step)
        params = restored.get("params", restored) \
            if isinstance(restored, dict) else restored
        if self._user_apply is not None:
            user_fn = self._user_apply
            apply = lambda x: np.asarray(user_fn(params, x))  # noqa: E731
        else:
            apply = self._build_apply(params)
        loaded = step
        # The bucket bit-exactness tripwire (docs/serving.md): every
        # bucket shape must produce row-stable results BEFORE this
        # replica admits traffic on them. Also doubles as the warmup
        # (cuBLAS and cuDNN handles, the allocator).
        buckets = self._buckets()
        batching.assert_bucket_equality(
            apply, buckets,
            np.zeros(self.sample_shape, np.float32) + 0.5)
        with self._apply_lock:
            self._apply = apply
            self.step = loaded

    def _loaded_state(self) -> Tuple[Optional[Callable], Optional[int]]:
        """Atomic (apply, step) snapshot: the hot-reload poller swaps
        the pair under the lock, so readers that look at both must
        take it too, or a reload landing between the two reads sees a
        torn pair."""
        with self._apply_lock:
            return self._apply, self.step

    def _run_batch(self, rows: np.ndarray) -> np.ndarray:
        apply, step = self._loaded_state()
        out = np.asarray(apply(rows)).view(_SteppedOutput)
        # The step rides WITH the outputs it produced: a hot reload
        # landing between this batch and the response serialization
        # must not relabel step-N outputs as step N+1 (the batcher's
        # per-request slices preserve the subclass + attribute).
        out.step = step
        return out

    def _start_batcher(self):
        self._batcher = batching.MicroBatcher(
            self._run_batch, name=self.replica_id, **self._batcher_cfg)

    # --- HTTP surface -------------------------------------------------------

    _json = staticmethod(json_route_result)

    def _handle_predict(self, body: bytes):
        with self._drain_lock:
            draining = self._draining
        if draining:
            # New work is refused the moment drain begins; the router
            # already benched us and retries this forward elsewhere
            # (503 is a 5xx: it charges our breaker budget, which is
            # moot — we are leaving). Queued work keeps finishing.
            return self._json(503, {"error": "draining",
                                    "replica": self.replica_id})
        try:
            doc = json.loads(body.decode() or "{}")
            inputs = np.asarray(doc["inputs"], dtype=np.float32)
        except (ValueError, KeyError, TypeError) as e:
            return self._json(400, {"error": "bad request: %s" % e})
        if self.sample_shape is not None:
            if inputs.shape == tuple(self.sample_shape):
                inputs = inputs[None]  # single row without batch dim
            elif inputs.shape[1:] != tuple(self.sample_shape):
                return self._json(400, {
                    "error": "inputs shape %r does not match model "
                             "sample shape %r"
                             % (list(inputs.shape),
                                list(self.sample_shape))})
        elif inputs.ndim == 1:
            inputs = inputs[None]
        try:
            fut = self._batcher.submit(inputs)
            out = fut.result(timeout=float_env(
                "HVD_SERVE_PROXY_TIMEOUT_SEC", 30.0))
        except ValueError as e:
            return self._json(400, {"error": str(e)})
        except Exception as e:  # analysis: allow-broad-except — any
            # batch failure maps to a 500 on THIS request; the server
            # and batcher keep running.
            return self._json(500, {"error": "inference failed: %s" % e})
        # Prefer the step tag the batch itself carried (_SteppedOutput):
        # it names the checkpoint that actually computed these rows. The
        # locked snapshot is only the fallback for apply fns routed
        # around _run_batch.
        step = getattr(out, "step", None)
        if step is None:
            _, step = self._loaded_state()
        return self._json(200, {
            "outputs": out.tolist(),
            "rows": int(inputs.shape[0]),
            "model": self.model,
            "step": step,
            "replica": self.replica_id,
        })

    def _handle_healthz(self):
        apply, step = self._loaded_state()
        with self._drain_lock:
            draining = self._draining
        return self._json(200, {
            "ok": apply is not None,
            "role": "replica",
            "replica": self.replica_id,
            "model": self.model,
            "step": step,
            "state": "draining" if draining else "serving",
            "pid": os.getpid(),
            "port": self.port,
        })

    def _handle_reload(self, body: bytes):
        """``POST /v1/reload {"step": N}``: restore exactly step N —
        the rolling-upgrade controller's directed reload (and its
        rollback: N may be LOWER than the serving step, which the
        latest-only poller would never do). The bucket self-check
        inside _restore_step re-runs before the swap, so a reloaded
        replica re-enters rotation with warm compiled buckets. A bad
        checkpoint maps to a 500 (the roll gate aborts on it) and the
        currently loaded step keeps serving."""
        try:
            doc = json.loads(body.decode() or "{}")
            step = int(doc["step"])
        except (ValueError, TypeError, KeyError):
            return self._json(400, {"error":
                                    "body must be JSON with int 'step'"})
        if self._ckpt is None:
            return self._json(400, {
                "error": "replica has no checkpoint directory to "
                         "reload from",
                "replica": self.replica_id})
        _, loaded = self._loaded_state()
        with self._reload_lock:
            if loaded != step:
                try:
                    self._restore_step(step)
                    _C_RELOADS.inc()
                except Exception as e:  # analysis: allow-broad-except
                    # — a half-written/GC'd/poisoned step must answer
                    # 500, not kill the handler thread; the loaded
                    # step keeps serving.
                    logger.warning(
                        "serve replica %s directed reload to step %s "
                        "failed: %s", self.replica_id, step, e)
                    _, still = self._loaded_state()
                    return self._json(500, {
                        "error": "reload to step %d failed: %s"
                                 % (step, e),
                        "step": still,
                        "replica": self.replica_id})
        _, now_step = self._loaded_state()
        logger.info("serve replica %s serving step %s (directed reload)",
                    self.replica_id, now_step)
        return self._json(200, {"ok": True, "step": now_step,
                                "replica": self.replica_id})

    def _handle_drain(self, body: bytes):
        """``POST /v1/drain``: enter graceful drain (idempotent)."""
        self.begin_drain(reason="http")
        return self._json(200, {"ok": True, "replica": self.replica_id,
                                "draining": True})

    # --- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._server.port if self._server is not None else None

    def endpoint_payload(self) -> dict:
        """What registration and every heartbeat carry: enough for a
        router (fresh or journal-replayed) to route to this replica,
        plus the lifecycle flag — a ``draining`` beat benches this
        replica at the router within one heartbeat period even if the
        immediate drain beat was lost."""
        _, step = self._loaded_state()
        payload = {
            "ts": time.time(),
            "pid": os.getpid(),
            "addr": self.advertise_addr,
            "port": self.port,
            "model": self.model,
            "step": step,
        }
        with self._drain_lock:
            if self._draining:
                payload["draining"] = True
        return payload

    def _send_beat(self, goodbye: bool = False) -> bool:
        """One immediate best-effort heartbeat PUT, outside the loop's
        cadence: the drain-entry beat (router benches us NOW) and the
        goodbye beat (router culls us NOW)."""
        ep = self._router_endpoint()
        if ep is None:
            return False
        payload = self.endpoint_payload()
        if goodbye:
            payload["draining"] = True
            payload["goodbye"] = True
        try:
            write_kv(ep[0], ep[1], "heartbeat", self.replica_id,
                     json.dumps(payload).encode(), timeout=5)
            _C_HEARTBEATS.inc()
            return True
        except OSError:
            return False

    def _router_endpoint(self) -> Optional[Tuple[str, int]]:
        if not self.router:
            return None
        addr, _, port = self.router.rpartition(":")
        return addr, int(port)

    def register(self) -> bool:
        """One best-effort registration PUT (replica/<id>); False when
        the router is unreachable (it may be mid-restart — the
        heartbeat loop keeps trying forever)."""
        ep = self._router_endpoint()
        if ep is None:
            return False
        try:
            write_kv(ep[0], ep[1], "replica", self.replica_id,
                     json.dumps(self.endpoint_payload()).encode(),
                     timeout=5)
            return True
        except OSError:
            return False

    def _heartbeat_loop(self):
        ep = self._router_endpoint()
        # Same phase jitter as the elastic worker (docs/fleet.md): a
        # fleet of replicas started by one scale-up would otherwise
        # beat the router in lockstep every HVD_HEARTBEAT_SEC.
        self._stop.wait(random.uniform(
            0.0, max(0.05, float_env("HVD_HEARTBEAT_SEC", 10.0))))
        while not self._stop.is_set():
            try:
                write_kv(ep[0], ep[1], "heartbeat", self.replica_id,
                         json.dumps(self.endpoint_payload()).encode(),
                         timeout=5)
                _C_HEARTBEATS.inc()
            except Exception as e:  # analysis: allow-broad-except —
                # the elastic heartbeat discipline: a down/garbled
                # router must never kill a healthy replica's beat loop.
                logger.debug("serve replica heartbeat failed: %s", e)
            self._stop.wait(max(0.05, float_env("HVD_HEARTBEAT_SEC", 10.0)))

    def _ckpt_poll_loop(self):
        while not self._stop.is_set():
            self._stop.wait(max(0.05, float_env(
                "HVD_SERVE_CKPT_POLL_SEC", 10.0)))
            if self._stop.is_set():
                return
            try:
                latest = self._ckpt.latest_step()
                _, step = self._loaded_state()
                if latest is not None and (step is None
                                           or latest > step):
                    self._restore_step(latest)
                    _C_RELOADS.inc()
                    logger.info("serve replica %s hot-reloaded step %s",
                                self.replica_id, latest)
            except Exception as e:  # analysis: allow-broad-except — a
                # half-written or GC'd step must not kill the poller;
                # the currently loaded step keeps serving.
                logger.warning("serve replica %s checkpoint poll "
                               "failed: %s", self.replica_id, e)

    def _start_tuner(self):
        """HVD_TUNE: online-tune the micro-batch fire triggers for
        THIS replica (objective: rows served/sec through its own
        batcher — replica-local, unlike the router's request
        counter), decisions
        journaled per replica id so a respawned replica replays to its
        tuned batcher instead of re-searching (docs/autotune.md)."""
        from horovod_tpu_torch.utils import online_tuner

        batcher = self._batcher
        online_tuner.start_online_tuner(
            role="serve", name="replica.%s" % self.replica_id,
            setters={
                "serve_max_batch":
                    lambda v: batcher.set_tunables(max_batch=v),
                "serve_deadline_ms":
                    lambda v: batcher.set_tunables(deadline_ms=v),
            })

    def begin_drain(self, reason: str = "signal"):
        """Enter graceful drain (idempotent): flag the beats, refuse
        new predicts, finish queued micro-batches on a background
        thread, goodbye-beat, release serve_forever. Never blocks the
        caller — SIGTERM handlers and HTTP threads both land here."""
        with self._drain_lock:
            if self._draining:
                return
            self._draining = True
        from horovod_tpu_torch.utils import flightrec

        flightrec.record("serve_drain", replica=self.replica_id,
                         reason=reason)
        logger.info("serve replica %s draining (%s)",
                    self.replica_id, reason)
        # Immediate draining beat: the router benches us before the
        # next scheduled heartbeat would.
        self._send_beat()
        t = threading.Thread(target=self._drain_and_exit, daemon=True,
                             name="hvd-serve-drain")
        t.start()
        self._threads.append(t)

    def _drain_and_exit(self):
        grace = float_env("HVD_SERVE_DRAIN_GRACE_SEC", 30.0)
        drained = True
        if self._batcher is not None:
            drained = self._batcher.drain(timeout=grace)
        if not drained:
            logger.warning(
                "serve replica %s drain grace (%.1fs) expired with "
                "work still queued; exiting anyway", self.replica_id,
                grace)
        # Goodbye: the router culls us now instead of after the
        # liveness window; best-effort — a down router sweeps us by
        # silence soon enough.
        self._send_beat(goodbye=True)
        self._stop.set()

    def start(self):
        """Load the model, bind the HTTP server, start heartbeats and
        the checkpoint poller. Returns the bound port."""
        self.load()
        self._start_tuner()
        self._server = KVStoreServer(port=self._requested_port)
        self._server.register_post_route("/v1/predict",
                                         self._handle_predict)
        self._server.register_post_route("/v1/reload", self._handle_reload)
        self._server.register_post_route("/v1/drain", self._handle_drain)
        self._server.register_get_route("/healthz", self._handle_healthz)
        self._server.start()
        self.register()
        if (self._router_endpoint() is not None
                and float_env("HVD_HEARTBEAT_SEC", 10.0) > 0):
            t = threading.Thread(target=self._heartbeat_loop, daemon=True,
                                 name="hvd-serve-heartbeat")
            t.start()
            self._threads.append(t)
        if (self._ckpt is not None
                and float_env("HVD_SERVE_CKPT_POLL_SEC", 10.0) > 0):
            t = threading.Thread(target=self._ckpt_poll_loop, daemon=True,
                                 name="hvd-serve-ckpt-poll")
            t.start()
            self._threads.append(t)
        return self.port

    def stop(self):
        self._stop.set()
        from horovod_tpu_torch.utils import online_tuner

        online_tuner.stop_online_tuner()
        if self._batcher is not None:
            self._batcher.stop()
        if self._server is not None:
            self._server.stop()
        for t in self._threads:
            t.join(timeout=5)

    def serve_forever(self):
        """Block until killed (the ``--role replica`` CLI path)."""
        try:
            while not self._stop.wait(3600):
                pass
        except KeyboardInterrupt:
            self.stop()


def _install_drain_on_sigterm(replica: Replica):
    """First SIGTERM = graceful drain (finish the queue, goodbye-beat,
    exit 0 — Server.stop's terminate() lands here). A second SIGTERM
    escalates to the default immediate kill, so a wedged drain can
    still be stopped by hand."""
    import signal

    def handler(signum, frame):
        if replica._draining:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
            return
        replica.begin_drain(reason="SIGTERM")

    signal.signal(signal.SIGTERM, handler)


def main(args) -> int:
    logging.basicConfig(level=logging.INFO)
    replica = Replica(model=args.model, ckpt_dir=args.ckpt_dir,
                      router=args.router, replica_id=args.replica_id,
                      port=args.port, device=getattr(args, "device", None))
    port = replica.start()
    _install_drain_on_sigterm(replica)
    sys.stdout.write("SERVE_REPLICA_READY %s port=%d pid=%d\n"
                     % (args.replica_id, port, os.getpid()))
    sys.stdout.flush()
    replica.serve_forever()
    # serve_forever returned: a drain ran to completion (the goodbye
    # beat is already out) — tear down the batcher/server cleanly.
    replica.stop()
    return 0
