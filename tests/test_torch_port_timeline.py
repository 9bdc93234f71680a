"""The port's timeline (``horovod_tpu_torch/utils/timeline.py``) against
the JAX package's (``horovod_tpu/utils/timeline.py``).

* The same events on a fixed clock give the same JSON, byte for byte;
* a span of card tensors ends at its begin plus the card's milliseconds
  between the readiness and the done event, which its end carries as
  ``card_ms``; an untimed event ends it on the host's clock, and
  ``close`` waits for a done event that has not fired yet (stand-in
  events, since this machine has no card);
* ``hvd.start_timeline`` writes the Python timeline and the core's beside
  it, and ``HOROVOD_TIMELINE`` (with ``{rank}``) opens both at ``init``.
"""

import json
import threading
import time
from concurrent.futures import Future

import pytest
import torch

from horovod_tpu.utils import timeline as ref_tl

from horovod_tpu_torch.utils import timeline as port_tl


class _Clock:
    """``time`` with a perf_counter that steps 1 ms a call."""

    def __init__(self):
        self._t = 100.0
        self._lock = threading.Lock()

    def perf_counter(self):
        with self._lock:
            self._t += 1e-3
            return self._t

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)


def _events(tl):
    tl.begin("a", "allreduce", args={"seq": 0})
    tl.end("a", "allreduce", args={"status": "ok", "seq": 0})
    tl.instant("cycle")
    tl.begin("b", "allgather")
    tl.end("b", "allgather")
    tl.write_raw({"name": "raw", "ph": "X", "ts": 1, "dur": 2, "pid": 7})
    ok, bad, late = Future(), Future(), Future()
    tl.record_future("f.ok", "broadcast", ok, seq=3)
    tl.record_future("f.bad", "alltoall", bad)
    tl.record_future("f.late", "allreduce", late, seq=4)
    ok.set_result([1])
    bad.set_exception(RuntimeError("x"))
    tl.begin("c", "reducescatter", pid=5)
    tl.end("c", "reducescatter", pid=5)
    late.set_result([2])
    for i in range(100):  # past the inline flush threshold
        tl.instant("i%d" % i)


def _write(mod, path, monkeypatch):
    monkeypatch.setattr(mod, "time", _Clock())
    tl = mod.Timeline(str(path), mark_cycles=True)
    _events(tl)
    tl.close()
    with open(str(path)) as f:
        return f.read()


def test_the_same_events_give_the_same_json(tmp_path, monkeypatch):
    ref = _write(ref_tl, tmp_path / "ref.json", monkeypatch)
    got = _write(port_tl, tmp_path / "port.json", monkeypatch)
    assert got == ref
    events = json.loads(got.rstrip().rstrip(",") + "]")
    assert len(events) == 1 + 5 + 1 + 6 + 2 + 100


class _Event:
    """A stand-in for a card event: ``query()`` turns true at ``at``
    (monotonic), and ``elapsed_time`` gives the card's ms, or raises as
    an untimed event does."""

    def __init__(self, at=0.0, ms=None):
        self.at, self.ms = at, ms

    def query(self):
        return time.monotonic() >= self.at

    def elapsed_time(self, other):
        if self.ms is None or other.ms is None:
            raise RuntimeError("Both events must be created with timing")
        return other.ms - self.ms


def _card_future(ready, done):
    f = Future()
    f.card_ready, f.card_events = ready, [done]
    return f


def _read(path):
    """A timeline file: the Python writer leaves its array open, the
    core's closes it."""
    with open(str(path)) as f:
        text = f.read().rstrip()
    return json.loads(text if text.endswith("]")
                      else text.rstrip(",") + "]")


def test_card_spans_take_the_cards_duration(tmp_path, monkeypatch):
    monkeypatch.setattr(port_tl, "time", _Clock())
    tl = port_tl.Timeline(str(tmp_path / "tl.json"))
    timed = _card_future(_Event(ms=1.0), _Event(ms=3.5))
    untimed = _card_future(_Event(), _Event())
    later = _card_future(_Event(ms=0.0),
                         _Event(at=time.monotonic() + 0.3, ms=7.25))
    tl.record_future("timed", "allreduce", timed, seq=0)
    tl.record_future("untimed", "allreduce", untimed, seq=1)
    tl.record_future("later", "allreduce", later, seq=2)
    for f in (timed, untimed, later):
        f.set_result([0])
    tl.close()  # waits for "later"'s done event
    events = _read(tmp_path / "tl.json")
    spans = {}
    for e in events[1:]:
        spans.setdefault(e["name"], {})[e["ph"]] = e
    assert spans["timed"]["E"]["args"] == {"status": "ok", "seq": 0,
                                           "card_ms": 2.5}
    assert spans["timed"]["E"]["ts"] == pytest.approx(
        spans["timed"]["B"]["ts"] + 2500.0)
    assert "card_ms" not in spans["untimed"]["E"]["args"]
    assert spans["untimed"]["E"]["ts"] > spans["untimed"]["B"]["ts"]
    assert spans["later"]["E"]["args"]["card_ms"] == 7.25
    assert spans["later"]["E"]["ts"] == pytest.approx(
        spans["later"]["B"]["ts"] + 7250.0)
    # Each span keeps the reference's name and category.
    assert {e["cat"] for e in events[1:]} == {"allreduce"}


def test_a_failed_card_op_ends_at_once(tmp_path):
    tl = port_tl.Timeline(str(tmp_path / "tl.json"))
    f = _card_future(_Event(ms=0.0), _Event(at=float("inf"), ms=1.0))
    tl.record_future("err", "allreduce", f)
    f.set_exception(RuntimeError("boom"))
    t0 = time.monotonic()
    tl.close()
    assert time.monotonic() - t0 < 5
    end = [e for e in _read(tmp_path / "tl.json") if e.get("ph") == "E"]
    assert end[0]["args"] == {"status": "error"}


def test_start_timeline_writes_both_files(tmp_path, monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HVD_METRICS_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "env{rank}.json"))
    hvd.init(device="cpu")
    try:
        x = torch.ones(3)
        hvd.allreduce(x, name="env.x")
        hvd.start_timeline(str(tmp_path / "api.json"))
        assert (tmp_path / "env0.json.core.json").exists()
        hvd.allreduce(x, name="api.x")
        hvd.grouped_allreduce([x, x], name="api.g")
        hvd.stop_timeline()
        hvd.allreduce(x, name="after.x")
    finally:
        hvd.shutdown()
    env = [e for e in _read(tmp_path / "env0.json") if e["ph"] in "BE"]
    assert [(e["name"], e["cat"], e["ph"]) for e in env] == [
        ("env.x", "allreduce", "B"), ("env.x", "allreduce", "E")]
    api = [e for e in _read(tmp_path / "api.json") if e["ph"] in "BE"]
    assert [(e["name"], e["cat"], e["ph"]) for e in api] == [
        ("api.x", "allreduce", "B"), ("api.x", "allreduce", "E"),
        ("api.g", "allreduce", "B"), ("api.g", "allreduce", "E")]
    assert [e["args"]["seq"] for e in api if e["ph"] == "B"] == [1, 2]
    core = _read(tmp_path / "api.json.core.json")
    names = {e["args"]["name"] for e in core
             if e.get("name") == "thread_name"}
    assert {"api.x", "api.g.0", "api.g.1"} <= names
