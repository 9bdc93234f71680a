"""The port's flight recorder (``horovod_tpu_torch/utils/flightrec.py``)
against the JAX package's (``horovod_tpu/utils/flightrec.py``).

The same records give the same dump schema (header keys and values but
the clocks and the pid; events field for field but their timestamps), the
same ring drops and the same ``recent_failures``; the port's dumps read
back through ``tools/trace``'s loader; and the port's eager ops, its abort
paths and ``hvd.dump_flight_record`` write what the reference's do.
"""

import json
import os

import numpy as np
import pytest
import torch

from horovod_tpu.utils import flightrec as ref_fr

from horovod_tpu_torch.utils import flightrec as port_fr

CLOCKS = ("wall_ts", "mono_us", "pid")


def _records(rng, n):
    kinds = ["submit", "complete", "error", "elastic_commit", "kv_shed"]
    out = []
    for i in range(n):
        fields = {"op": str(rng.choice(["allreduce", "allgather"])),
                  "seq": int(i), "ps": int(rng.randint(3))}
        if rng.rand() < 0.3:
            fields["detail"] = "x" * int(rng.randint(5))
        out.append((str(rng.choice(kinds)), "t.%d" % rng.randint(9),
                    fields))
    return out


def _dump(mod, records, capacity, path):
    rec = mod.FlightRecorder(capacity=capacity)
    drops = [rec.record(k, name, **f) for k, name, f in records]
    n = rec.dump(str(path), rank=3, reason="test")
    with open(str(path)) as f:
        lines = [json.loads(line) for line in f]
    return drops, n, lines, rec.stats()


@pytest.mark.parametrize("n,capacity", [(10, 64), (64, 64), (100, 64),
                                        (500, 128)])
def test_dump_schema_and_drops_equal_the_reference(tmp_path, n, capacity):
    records = _records(np.random.RandomState(n), n)
    ref = _dump(ref_fr, records, capacity, tmp_path / "ref.jsonl")
    got = _dump(port_fr, records, capacity, tmp_path / "port.jsonl")
    assert got[0] == ref[0]  # which records overwrote an older one
    assert got[1] == ref[1] == min(n, capacity)
    assert got[3] == ref[3]
    (rh, *revents), (gh, *gevents) = ref[2], got[2]
    assert sorted(gh) == sorted(rh)
    assert {k: v for k, v in gh.items() if k not in CLOCKS} == \
        {k: v for k, v in rh.items() if k not in CLOCKS}
    assert gh["dropped"] == max(0, n - capacity)
    assert [dict(e, ts_us=0) for e in gevents] == \
        [dict(e, ts_us=0) for e in revents]
    assert all(a["ts_us"] <= b["ts_us"] for a, b in zip(gevents,
                                                        gevents[1:]))


def test_recent_failures_equal_the_reference(monkeypatch):
    for mod in (ref_fr, port_fr):
        monkeypatch.setattr(mod, "_recent_failures", [])
    for i in range(20):
        for mod in (ref_fr, port_fr):
            mod.record_failure("abort" if i % 3 else "sigterm",
                               "detail %d" % i, rank=i % 2)

    def strip(entries):
        return [{k: v for k, v in e.items() if k != "ts"} for e in entries]

    got, ref = port_fr.recent_failures(), ref_fr.recent_failures()
    assert len(got) == port_fr._RECENT_MAX == 16
    assert strip(got) == strip(ref)
    assert got[-1]["detail"] == "detail 19"


def test_the_port_dump_reads_back_through_tools_trace(tmp_path,
                                                      monkeypatch):
    from tools.trace import load_dir

    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HVD_FLIGHTREC_DIR", str(tmp_path))
    monkeypatch.delenv("HVD_FLIGHTREC", raising=False)
    port_fr.record("submit", name="trace.x", op="allreduce", ps=0, seq=0)
    port_fr.record("complete", name="trace.x", op="allreduce", ps=0, seq=0)
    paths = port_fr.dump(reason="test")
    assert "python" in paths
    dump = load_dir(str(tmp_path))[0]["python"]
    assert dump["header"]["source"] == "python"
    assert dump["header"]["reason"] == "test"
    assert [e["kind"] for e in dump["events"]][-2:] == ["submit",
                                                        "complete"]


def test_disabled_recorder_records_and_dumps_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_FLIGHTREC", "0")
    before = port_fr.recorder().stats()["events_total"]
    port_fr.record("submit", name="off")
    assert port_fr.recorder().stats()["events_total"] == before
    assert port_fr.dump(str(tmp_path)) == {}
    assert port_fr.dump_on_abort("off") == {}
    assert port_fr.install_signal_handler() is False


def test_eager_ops_dump_both_rings_with_submit_and_complete(tmp_path,
                                                            monkeypatch):
    """``hvd.dump_flight_record`` after eager ops at size 1: a Python file
    with a ``submit`` and a ``complete`` per op, stamped with the set's
    sequence numbers, and the core's native JSONL file with the ops'
    ENQUEUE records; an aborted world dumps on its own."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                 "HVD_METRICS_PORT", "HVD_FLIGHTREC"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HVD_FLIGHTREC_DIR", str(tmp_path / "auto"))
    hvd.init(device="cpu")
    try:
        x = torch.ones(5)
        names = ["fr.%d" % i for i in range(4)]
        handles = [hvd.allreduce_async(x, name=n) for n in names]
        for h in handles:
            hvd.synchronize(h)
        hvd.allgather(x, name="fr.ag")
        paths = hvd.dump_flight_record(str(tmp_path / "on_demand"))
        assert set(paths) == {"python", "native"}
        with open(paths["python"]) as f:
            header, *events = [json.loads(line) for line in f]
        assert header["flightrec"] == 1 and header["source"] == "python"
        assert header["reason"] == "hvd.dump_flight_record"
        mine = [e for e in events if e.get("name", "").startswith("fr.")]
        for n in names + ["fr.ag"]:
            kinds = [e["kind"] for e in mine if e["name"] == n]
            assert kinds == ["submit", "complete"], (n, kinds)
        seqs = [e["seq"] for e in mine if e["kind"] == "submit"]
        assert seqs == sorted(seqs) and len(set(seqs)) == 5
        with open(paths["native"]) as f:
            nheader, *nevents = [json.loads(line) for line in f]
        assert nheader["source"] == "native"
        enqueued = {e["name"] for e in nevents if e["kind"] == "ENQUEUE"}
        assert set(names + ["fr.ag"]) <= enqueued

        # The failure watch dumps both rings when it aborts the world.
        monkeypatch.setattr(port_fr, "_last_abort_dump", [-1e9])
        basics.watch().fail("a test's failure")
        auto = tmp_path / "auto"
        assert sorted(os.listdir(str(auto))) == [
            "flightrec.rank0.native.jsonl", "flightrec.rank0.python.jsonl"]
        assert port_fr.recent_failures()[-1]["detail"] == \
            "a test's failure"
    finally:
        hvd.shutdown()
