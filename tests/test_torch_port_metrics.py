"""The port's metrics registry (``horovod_tpu_torch/utils/metrics.py``)
against the JAX package's (``horovod_tpu/utils/metrics.py``).

* The same sequence of observations, made from a seed with numpy, gives
  the same ``render_prometheus()`` and the same JSON snapshot in both
  (fresh registries, so no clock-driven gauge is in them);
* ``quantile_from_buckets`` agrees on random bucket counts;
* every family the port registers has a name in docs/metrics.md, and the
  reference's type, help, labels and buckets;
* the eager ops at size 1 count, time and size themselves as the
  reference's do;
* np=2 gloo runs of the same eager ops on host tensors, each package in
  processes of its own (tests/torch_port_obs_worker.py, started through
  tests/torch_port_runs.py): the ``hvd_*`` counters and histogram counts
  equal the reference's, ``HOROVOD_TIMELINE`` gives the same span names
  and categories, and ``HOROVOD_AUTOTUNE=native`` starts the core's tuner,
  whose state each package reports.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from horovod_tpu.utils import metrics as ref_metrics

from horovod_tpu_torch.utils import metrics as port_metrics
from torch_port_runs import start_runs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_obs_worker.py")
MODES = ("jax", "port")
SEEDS = [0, 1, 2, 3]


def _observe(mod, seed):
    """One sequence of registrations and observations on a fresh
    registry of ``mod``; returns the registry."""
    reg = mod.MetricsRegistry()
    rng = np.random.RandomState(seed)
    c = reg.counter("hvd_test_events_total", "Events.\nTwo lines.")
    cl = reg.counter("hvd_test_ops_total", "Ops by kind.", ("op", "dtype"))
    g = reg.gauge("hvd_test_level", "A level.")
    gl = reg.gauge("hvd_test_levels", "Levels.", ("where",))
    h = reg.histogram("hvd_test_latency_seconds", "Latency.", ("op",))
    hb = reg.histogram("hvd_test_size_bytes", "Sizes.",
                       buckets=mod.DEFAULT_BYTES_BUCKETS)
    hc = reg.histogram("hvd_test_custom", "Custom ladder.",
                       buckets=(0.1, 1.0 / 3.0, 1048577.0, float("inf")))
    ops = ["allreduce", "allgather", 'quo"te', "back\\slash", "new\nline"]
    for _ in range(200):
        k = rng.randint(7)
        if k == 0:
            c.inc(float(rng.randint(1, 5)))
        elif k == 1:
            cl.labels(op=ops[rng.randint(len(ops))],
                      dtype=str(rng.choice(["f32", "bf16"]))).inc(
                float(rng.rand()))
        elif k == 2:
            g.set(float(rng.choice([rng.randn(), np.nan, np.inf,
                                    -np.inf, 1e20, 3.0])))
        elif k == 3:
            gl.labels(str(rng.randint(3))).inc(float(rng.randn()))
        elif k == 4:
            h.labels(ops[rng.randint(2)]).observe(
                float(10 ** rng.uniform(-5, 2)))
        elif k == 5:
            hb.observe(float(rng.choice([0, 256, 257, 1 << 20,
                                         rng.randint(1 << 30)])))
        else:
            hc.observe(float(rng.choice([0.1, 1.0 / 3.0, 0.2, 5.0,
                                         2e6])))
    for where, v in (("nan", np.nan), ("inf", np.inf), ("-inf", -np.inf)):
        gl.labels(where).set(v)
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_prometheus_text_equals_the_reference(seed):
    ref = _observe(ref_metrics, seed).render_prometheus()
    got = _observe(port_metrics, seed).render_prometheus()
    assert got == ref
    assert all(v in got for v in (" NaN\n", " +Inf\n", " -Inf\n"))


@pytest.mark.parametrize("seed", SEEDS)
def test_json_snapshot_equals_the_reference(seed):
    ref = json.dumps(ref_metrics._json_sanitize(
        _observe(ref_metrics, seed).snapshot()))
    got = json.dumps(port_metrics._json_sanitize(
        _observe(port_metrics, seed).snapshot()))
    assert got == ref
    json.loads(got)  # spec-valid: no bare NaN or Infinity


@pytest.mark.parametrize("seed", SEEDS)
def test_quantiles_from_buckets_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    bounds = sorted(set(np.round(10 ** rng.uniform(-4, 3, 12), 6)))
    for _ in range(50):
        counts = [int(x) for x in rng.randint(0, 5, len(bounds) + 1)]
        for q in (0.01, 0.5, 0.9, 0.99, 1.0):
            assert port_metrics.quantile_from_buckets(bounds, counts, q) \
                == ref_metrics.quantile_from_buckets(bounds, counts, q)
    assert port_metrics.quantile_from_buckets(bounds, [0] * 13, 0.5) is None


@pytest.mark.parametrize("bad", [
    lambda r: r.counter("hvd_Bad", "x"),
    lambda r: r.counter("nope_total", "x"),
    lambda r: (r.counter("hvd_twice", "x"), r.gauge("hvd_twice", "x")),
    lambda r: (r.counter("hvd_twice", "x", ("a",)),
               r.counter("hvd_twice", "x", ("b",))),
    lambda r: (r.histogram("hvd_ladder", "x", buckets=(1.0, 2.0)),
               r.histogram("hvd_ladder", "x", buckets=(1.0, 3.0))),
    lambda r: r.histogram("hvd_ladder", "x", buckets=(2.0, 1.0)),
    lambda r: r.counter("hvd_neg", "x").inc(-1),
    lambda r: r.counter("hvd_lbl", "x", ("a",)).labels("1", "2"),
])
def test_registration_errors_match_the_reference(bad):
    with pytest.raises(ValueError):
        bad(ref_metrics.MetricsRegistry())
    with pytest.raises(ValueError):
        bad(port_metrics.MetricsRegistry())


def _documented():
    with open(os.path.join(ROOT, "docs", "metrics.md")) as f:
        return f.read()


def test_every_port_family_is_the_references():
    """Every family the port's modules register: its name is in
    docs/metrics.md and the reference registers it with the same type,
    help, labels and buckets (the port adds no family of its own). The
    two wire-byte families' help adds one note, the device plane's NCCL
    bytes (``core/session._PLANE_BYTES_NOTE``)."""
    import importlib
    import pkgutil

    import horovod_tpu_torch
    from horovod_tpu_torch.core import session

    for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                   "horovod_tpu_torch."):
        importlib.import_module(m.name)
    for mod in ("horovod_tpu.ops.eager", "horovod_tpu.core.session",
                "horovod_tpu.utils.flightrec", "horovod_tpu.elastic.state",
                "horovod_tpu.elastic.worker", "horovod_tpu.data.data_loader",
                "horovod_tpu.runner.http_server",
                "horovod_tpu.runner.journal",
                "horovod_tpu.runner.elastic_run",
                "horovod_tpu.serve.autoscale", "horovod_tpu.serve.batching",
                "horovod_tpu.serve.replica", "horovod_tpu.serve.router",
                "horovod_tpu.serve.standby",
                "horovod_tpu.utils.online_tuner",
                "horovod_tpu.ops.block_tuner"):
        importlib.import_module(mod)
    doc = _documented()
    names = port_metrics.REGISTRY.names()
    assert len(names) >= 40, names
    for name in names:
        assert "`%s`" % name in doc, name
        mine = port_metrics.REGISTRY.get(name)
        ref = ref_metrics.REGISTRY.get(name)
        assert ref is not None, name
        assert (type(mine).__name__, mine.kind, mine.labelnames) == \
            (type(ref).__name__, ref.kind, ref.labelnames), name
        # The flight recorder's three families are registered by two
        # modules in each package (utils/flightrec.py and the core's
        # bridge) with two help texts: the first import's stays.
        if name in ("hvd_comm_tx_bytes_total", "hvd_comm_rx_bytes_total"):
            assert mine.documentation == \
                ref.documentation + session._PLANE_BYTES_NOTE, name
        elif not name.startswith("hvd_flightrec_"):
            assert mine.documentation == ref.documentation, name
        assert getattr(mine, "buckets", None) == \
            getattr(ref, "buckets", None), name


def test_health_gauges_follow_the_last_collective():
    reg = port_metrics.REGISTRY
    port_metrics.mark_collective()
    since = reg.value("hvd_seconds_since_last_collective")
    assert 0.0 <= since < 5.0
    port_metrics.set_pending_tensors(3, 1)
    assert reg.value("hvd_pending_tensors") == 3
    assert reg.value("hvd_stalled_tensors") == 1
    port_metrics.set_pending_tensors(0, 0)
    reporter = port_metrics.HealthReporter(interval=0.05)
    reporter.start()
    try:
        assert reporter._thread is not None
    finally:
        reporter.stop()
    assert port_metrics.HealthReporter(interval=0)._thread is None


def _delta(before, after, name, **labels):
    def get(snap):
        for v in snap.get(name, {}).get("values", []):
            if all(v["labels"].get(k) == str(x) for k, x in labels.items()):
                return v.get("value", v.get("count"))
        return 0
    return get(after) - get(before)


def test_eager_ops_at_size_one_are_counted(monkeypatch):
    """Every eager op at size 1 (on the native core, as at any size) is
    counted, timed and sized under the reference's op labels; an error
    is counted apart; the server exports it."""
    import urllib.request

    import horovod_tpu_torch as hvd

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                 "HVD_METRICS_PORT"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        before = hvd.metrics_snapshot()
        x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        assert torch.equal(hvd.allreduce(x, name="m.x"), x)
        hvd.grouped_allreduce([x, x[:1]], name="m.g")
        hvd.allgather(x, name="m.ag")
        hvd.broadcast(x, 0, name="m.b")
        hvd.alltoall(x, name="m.a2a")
        hvd.reducescatter(x, name="m.rs")
        hvd.barrier()
        hvd.join()
        with pytest.raises(hvd.HorovodInternalError, match="splits"):
            hvd.alltoall(x, [2], name="m.bad")
        after = hvd.metrics_snapshot()
        for op in ("allreduce", "grouped_allreduce", "allgather",
                   "broadcast", "alltoall", "reducescatter", "barrier",
                   "join"):
            assert _delta(before, after, "hvd_collectives_total",
                          op=op) == 1, op
            # The failed alltoall is timed too, as in the reference.
            assert _delta(before, after, "hvd_collective_latency_seconds",
                          op=op) == 1 + (op == "alltoall"), op
        assert _delta(before, after, "hvd_collective_errors_total",
                      op="alltoall") == 1
        assert _delta(before, after, "hvd_core_allreduced_tensors_total") \
            == 3
        assert _delta(before, after, "hvd_core_allreduce_bytes_total") \
            == 48 + 48 + 12
        sizes = [v for v in after["hvd_collective_bytes"]["values"]
                 if v["labels"]["op"] == "grouped_allreduce"][0]
        assert sizes["sum"] >= 60
        assert after["hvd_recent_failures"]["type"] == "info"
        port = hvd.start_metrics_server(0)
        assert hvd.start_metrics_server(0) == port
        text = urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % port, timeout=10).read().decode()
        assert 'hvd_collectives_total{op="alltoall"}' in text
        snap = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics.json" % port,
            timeout=10).read())
        assert "hvd_core_responses_total" in snap
        req = urllib.request.Request("http://127.0.0.1:%d/x/y" % port,
                                     data=b"1", method="PUT")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 405  # a scrape target takes no writes
        hvd.stop_metrics_server()
    finally:
        hvd.shutdown()
    assert port_metrics.REGISTRY.value("hvd_pending_tensors") == 0
    assert math.isfinite(
        port_metrics.REGISTRY.value("hvd_seconds_since_last_collective"))


# --- np=2: both packages on the same eager ops -----------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    specs = [((mode, tune), 2, [mode] + (["native"] if tune else []))
             for mode in MODES for tune in ("", "native")]

    def env(key):
        return {"HOROVOD_TIMELINE": str(tmp / ("tl_%s_%s_{rank}.json"
                                                % key)),
                "HOROVOD_AUTOTUNE": key[1], "HVD_FLIGHTREC_DIR": str(tmp),
                "HOROVOD_CYCLE_TIME": "1"}

    return start_runs(WORKER, specs, tmp, env=env)


def _snapshot(res):
    """The run's metrics over its eager ops: every counter, gauge and
    histogram as its change from before them to after (gauges as their
    value after)."""
    before, after = (json.loads(str(res[k])) for k in ("before",
                                                       "snapshot"))
    out = {}
    for name, fam in after.items():
        if fam["type"] not in ("counter", "histogram"):
            out[name] = fam["values"]
            continue
        old = {json.dumps(v["labels"], sort_keys=True): v
               for v in before.get(name, {}).get("values", [])}
        vals = []
        for v in fam["values"]:
            o = old.get(json.dumps(v["labels"], sort_keys=True), {})
            if fam["type"] == "counter":
                d = {"value": v["value"] - o.get("value", 0.0)}
            else:
                d = {"count": v["count"] - o.get("count", 0),
                     "sum": v["sum"] - o.get("sum", 0.0),
                     "buckets": {b: n - o.get("buckets", {}).get(b, 0)
                                 for b, n in v["buckets"].items()}}
            if any(d.values()) if fam["type"] == "counter" else d["count"]:
                vals.append(dict(d, labels=v["labels"]))
        out[name] = vals
    return out


# Families whose changes the same ops make equal in both packages (the
# response, fusion and wire-byte counts depend on how the ops fell into
# negotiation cycles).
_DETERMINED = ("hvd_collectives_total", "hvd_collective_errors_total",
               "hvd_core_allreduced_tensors_total",
               "hvd_core_allreduce_bytes_total", "hvd_pending_tensors",
               "hvd_stalled_tensors")


@pytest.mark.parametrize("rank", [0, 1])
def test_np2_counters_and_histograms_equal_the_reference(runs, rank):
    ref = _snapshot(runs["jax", ""][rank])
    got = _snapshot(runs["port", ""][rank])
    for name in _DETERMINED:
        assert got.get(name) == ref.get(name), name
    assert {v["labels"]["op"] for v in got["hvd_collectives_total"]} == {
        "allreduce", "grouped_allreduce", "allgather", "broadcast",
        "alltoall", "reducescatter", "barrier", "join"}
    assert got["hvd_core_allreduced_tensors_total"][0]["value"] == 11
    lat = got["hvd_collective_latency_seconds"]
    assert [(v["labels"], v["count"]) for v in lat] == \
        [(v["labels"], v["count"])
         for v in ref["hvd_collective_latency_seconds"]]
    assert got["hvd_collective_bytes"] == ref["hvd_collective_bytes"]
    # The reference's process makes one family the port has not: the
    # count of in-graph collectives traced under jit. Both inits import
    # their flash tile tuner at size 2 (its cache sync), so both have its
    # trials. Each of the port's families is one of the reference's
    # (test_every_port_family_is_the_references). The online tuner's
    # hvd_tune_* families exist in a process that imported its module, in
    # either package.
    tune = {n for n in set(ref) | set(got) if n.startswith("hvd_tune_")}
    assert set(ref) - set(got) - tune == {
        "hvd_ingraph_collective_traces_total"}
    assert "hvd_flash_tuner_trials_total" in got
    assert got["hvd_recent_failures"] == ref["hvd_recent_failures"] == []


def _spans(res):
    """The workload's spans (the reference's init adds its tile tuner's
    cache sync) as (name, category, phase, status)."""
    text = str(res["timeline"]).rstrip()
    events = json.loads(text.rstrip(",") + "]")
    return sorted((e["name"], e["cat"], e["ph"],
                   (e.get("args") or {}).get("status"))
                  for e in events
                  if e["ph"] in "BE" and e["name"].startswith("obs."))


@pytest.mark.parametrize("rank", [0, 1])
def test_np2_timeline_spans_equal_the_reference(runs, rank):
    got = _spans(runs["port", ""][rank])
    assert got == _spans(runs["jax", ""][rank])
    assert ("obs.g", "allreduce", "B", None) in got
    assert ("obs.a2a", "alltoall", "E", "ok") in got


@pytest.mark.parametrize("mode", MODES)
def test_np2_native_autotune_reports_its_state(runs, mode):
    states = [json.loads(str(r["autotune"])) for r in runs[mode, "native"]]
    keys = {"fusion_mb", "cycle_ms", "done", "samples", "cache_enabled",
            "hierarchical", "categorical_samples"}
    for state in states:
        assert set(state) == keys
        assert 0.0 <= state["fusion_mb"] <= 128.0
        assert 1.0 <= state["cycle_ms"] <= 100.0
    # The coordinator scores the samples.
    assert states[0]["samples"] >= 2, states


def test_a_started_server_is_bound_again_after_a_reset(monkeypatch):
    """A server started before an elastic shutdown/init cycle serves on
    the same port after it; an explicit stop means stay stopped; and
    ``HVD_METRICS_PORT`` serves on base + local_rank at ``init``."""
    import socket
    import urllib.request

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                 "HVD_METRICS_PORT", "HOROVOD_LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    port = hvd.start_metrics_server(0)
    hvd.shutdown()
    assert basics._ctx.metrics_server is None
    hvd.init(device="cpu")
    try:
        assert basics._ctx.metrics_server.port == port
        with urllib.request.urlopen("http://127.0.0.1:%d/metrics" % port,
                                    timeout=10) as r:
            assert r.status == 200
        hvd.stop_metrics_server()
    finally:
        hvd.shutdown()
    hvd.init(device="cpu")
    try:
        assert basics._ctx.metrics_server is None
    finally:
        hvd.shutdown()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
    monkeypatch.setenv("HVD_METRICS_PORT", str(base))
    hvd.init(device="cpu")
    try:
        assert basics._ctx.metrics_server.port == base  # local rank 0
    finally:
        hvd.shutdown()
