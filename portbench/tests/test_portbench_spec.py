"""The harness is driven by data: a cell, a configuration, a traffic mix
and a per-layer metric are added by adding files and entries, and the
result line has the keys the contract names."""

import hashlib
import json
import os
import re

import pytest

import portbench_tiny as tiny
from portbench import judge, readers, spec
from portbench import run as prun

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _hashes(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    root = tiny.tiny_root(str(tmp_path), tiny.LM)
    before = _hashes(root)
    here = os.path.join(root, "portbench")
    with open(os.path.join(here, "configs", "toy-lm.json"), "w") as f:
        json.dump(dict(tiny.TINY_CONFIG["transformer"], family="transformer",
                       initializer_range=0.02, layer_norm_epsilon_run=1e-6),
                  f)
    with open(os.path.join(here, "traffic", "toy.json"), "w") as f:
        json.dump({"batch": 2, "seq_len": 8, "zipf_s": 1.1, "pool": 3,
                   "optimizer": {"name": "sgd", "lr": 0.1, "momentum": 0.9},
                   "check_steps": 3, "trace_steps": 1}, f)
    with open(os.path.join(here, "limits", "toy-lm.toy.json"), "w") as f:
        json.dump({"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4},
                  f)
    with open(os.path.join(here, "metrics", "toy_steps.lm.py"), "w") as f:
        f.write("def read(run):\n"
                "    return float(run.ranks[0]['window']['steps'])\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-lm", "source": "a test",
                             "file": "portbench/configs/toy-lm.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-lm.toy", "config": "toy-lm",
                               "traffic": "toy", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "toy_steps.lm", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "training script",
                               "moves": "tokens_per_s",
                               "workloads": ["toy-lm.toy"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "tokens_per_s")["workloads"].append("toy-lm.toy")
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("toy-lm.toy", root)
    assert cell.traffic["seq_len"] == 8 and cell.config["n_layer"] == 2
    assert [m["name"] for m in cell.per_layer] == ["toy_steps.lm"]
    record = tiny.run_tiny(cell)
    result, correct, _ = prun.compose(cell, [record], False)
    assert correct and "tokens_per_s" in result["metrics"]
    record["trace"] = {"busy_s": 1.0, "window_s": 2.0, "names": [],
                       "kernels": [], "device_ops": [], "idle_gaps": [],
                       "steps": 1}
    result, _, _ = prun.compose(cell, [record], True)
    assert result["metrics"] == {"toy_steps.lm": {
        "value": float(record["window"]["steps"]), "unit": "steps"}}
    assert before == {p: h for p, h in _hashes(root).items() if p in before}


def test_result_line_keys(tmp_path):
    cell = tiny.tiny_cell(str(tmp_path), tiny.RN)
    record = tiny.run_tiny(cell)
    result, _, _ = prun.compose(cell, [record], False)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == set(cell.limits)
    assert list(result)[-1] == "checks"
    assert all(set(v) == {"value", "limit"}
               for v in result["checks"].values())
    record["trace"] = {"busy_s": 0.5, "window_s": 2.0, "steps": 1,
                       "names": ["conv_fprop", "batch_norm_fw"],
                       "kernels": [[0, 0.1, 0.3], [1, 0.4, 0.7]],
                       "device_ops": [["conv_fprop", 0.2]],
                       "idle_gaps": [["forward:aten::conv2d", 1.5]]}
    result, _, _ = prun.compose(cell, [record], True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result["device"]["busy_s"] == 0.5
    assert result["device"]["window_s"] == 2.0
    assert result["metrics"]["idle_share.rn50"]["value"] == pytest.approx(75)
    assert result["metrics"]["bn_elementwise_ms.rn50"]["value"] == \
        pytest.approx(300)
    json.dumps(result)


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(
            spec.HERE, "metrics", m["name"] + ".py"))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert cell.limits and set(cell.limits) <= set(judge.NUMBERS)
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/")
    assert len(json.dumps(bench)) < 64 * 1024


def test_readers_find_nothing_in_an_empty_trace():
    cell = tiny.load_cell(tiny.LM)
    trace = {"busy_s": 1.0, "window_s": 1.0, "names": [], "kernels": [],
             "device_ops": [], "idle_gaps": [], "steps": 1}
    run = readers.Run(cell, {}, [{"trace": trace,
                                  "window": {"opt_step_ms": []}}])
    for name in ("flash_fwd_roofline.lm", "flash_bwd_roofline.lm",
                 "gemm_ms.lm", "allreduce_exposed_ms.lm", "mfu.lm",
                 "host_issue_ms.lm", "opt_step_ms.lm"):
        assert spec.load_reader(name)(run) is None, name
