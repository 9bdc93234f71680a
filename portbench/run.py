"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

On one chip the cell runs in this process; on more, through the port's
launcher, one process a card (``worker.py``). With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read by ``metrics/<name>.py`` from the traced steps. Every run
compares the checked steps with the plain reference and prints each
number compared beside its limit, last on standard error and last in the
line. Without a card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with another code than 0."""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import judge, readers, spec, worker  # noqa: E402

# The whole run's limit, set-up (and a first run's builds) included.
RUN_LIMIT_S = 350.0
# Every build and kernel cache, at fixed paths inside the checkout.
CACHE_DIR = os.path.join(spec.ROOT, ".portbench_cache")


def cache_env() -> dict:
    return {"TORCH_EXTENSIONS_DIR": os.path.join(CACHE_DIR,
                                                 "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(CACHE_DIR, "triton"),
            "USE_FLAX": "0"}


def _kill_group(pid: int) -> None:
    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def launch(cell, args, platform: str = "gpu", script=None) -> list:
    """Run the cell's ranks through ``python -m horovod_tpu_torch.runner``
    and return their records; every process started is ended and waited
    for. The tests run them on gloo (``platform`` "cpu") and may give
    another rank program, ``script`` (its path and first arguments),
    which takes ``worker.main``'s flags."""
    out = tempfile.mkdtemp(prefix="portbench-")
    env = dict(os.environ, PORTBENCH_T0=repr(T0))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(cell.chips), "--platform", platform, sys.executable] \
        + (script or [os.path.join(spec.HERE, "worker.py")]) + [
           "--workload", cell.name, "--seed", str(args.seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--out", out, "--root", cell.root]
    proc = subprocess.Popen(cmd, cwd=spec.ROOT, env=env, stdout=2,
                            stderr=2, start_new_session=True)
    try:
        rc = proc.wait(timeout=max(1.0, RUN_LIMIT_S - (time.time() - T0)))
    except subprocess.TimeoutExpired:
        sys.stderr.write("portbench: the ranks outlasted %.0f s\n"
                         % RUN_LIMIT_S)
        rc = None
    finally:
        _kill_group(proc.pid)
        proc.wait()
        pids = []
        for name in os.listdir(out):
            if name.startswith("pid"):
                with open(os.path.join(out, name)) as f:
                    pids.append(int(f.read()))
        for pid in pids:
            _kill_group(pid)
        deadline = time.time() + 30
        while any(_alive(p) for p in pids) and time.time() < deadline:
            time.sleep(0.1)
        records = []
        for r in range(cell.chips):
            path = os.path.join(out, "rank%d.json" % r)
            if os.path.exists(path):
                with open(path) as f:
                    records.append(json.load(f))
        shutil.rmtree(out, ignore_errors=True)
    if rc != 0 or len(records) != cell.chips:
        raise RuntimeError("the launcher exited with %s and %d of %d ranks "
                           "wrote a record" % (rc, len(records), cell.chips))
    return records


def end_to_end(cell, records) -> dict:
    """Every end-to-end number of the run, from rank 0's window (the
    ranks step together) and every rank's peak memory."""
    win = records[0]["window"]
    rate = win["steps"] * win["units"] / win["seconds"]
    values = {"setup_s": records[0]["setup_s"],
              "peak_mem_gib": max(r["peak_bytes"] for r in records) / 2**30,
              "step_ms_p90": _p90(win["step_ms"])}
    values["tokens_per_s" if cell.family == "transformer"
           else "images_per_s"] = rate
    return values


def _p90(values) -> float:
    import statistics

    return statistics.quantiles(values, n=10)[-1] if len(values) > 1 \
        else values[0]


def compose(cell, records, traced: bool):
    """(result line, correct, the numbers compared)."""
    r0 = records[0]
    e2e = end_to_end(cell, records)
    if traced:
        run = readers.Run(cell, e2e, records)
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"], cell.root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, nums = judge.judge(r0["program"], r0["reference"], cell.limits)
    losses = r0["window"]["losses"]
    device = {"platform": "gpu", "kind": r0["device"], "count": len(records),
              "memory_peak_bytes": max(r["peak_bytes"] for r in records)}
    result = {"correct": correct, "attempted": r0["window"]["steps"],
              "failed": sum(1 for x in losses if not math.isfinite(x)),
              "metrics": metrics, "device": device}
    if traced:
        traces = [r["trace"] for r in records]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        result["breakdown"] = {"device_ops": r0["trace"]["device_ops"],
                               "idle_gaps": r0["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in nums.items() if "limit" in v}
    return result, correct, nums


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    os.environ.update(cache_env())
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        sys.stderr.write("portbench: %s needs %d CUDA card(s); this "
                         "machine shows %d\n"
                         % (cell.name, cell.chips,
                            torch.cuda.device_count()
                            if torch.cuda.is_available() else 0))
        return 2
    if cell.chips == 1:
        records = [worker.run_rank(cell, args.seed, args.seconds,
                                   bool(args.trace), T0)]
    else:
        records = launch(cell, args)
    found = sorted(set(worker.forbidden_modules()).union(
        *(r["forbidden"] for r in records)))
    if found:
        sys.stderr.write("portbench: loaded once the window closed: %s\n"
                         % ", ".join(found))
        return 3
    result, correct, nums = compose(cell, records, bool(args.trace))
    r0 = records[0]
    sys.stderr.write(
        "portbench: %s on %d x %s: %d window steps in %.3f s, %d buckets a "
        "step, set-up %.3f s, reference %.3f s\n"
        % (cell.name, len(records), r0["device"], r0["window"]["steps"],
           r0["window"]["seconds"], r0["buckets"], r0["setup_s"],
           r0["reference_s"]))
    sys.stderr.write("portbench: set-up phases (s from the start): %s\n"
                     % ", ".join("%s %.3f" % kv
                                 for kv in r0["setup_phases"]))
    sys.stderr.write("portbench: losses program %s reference %s\n"
                     % (r0["program"]["losses"], r0["reference"]["losses"]))
    sys.stderr.write("correct %s; readings: %s\n" % (
        str(correct).lower(), ", ".join(
            "%s %.6g%s" % (k, v["value"], " (leaf %s)" % v["leaf"]
                           if "leaf" in v else "")
            for k, v in nums.items())))
    for what in judge.DIRECTIONS:
        leaves = judge.leaf_diffs(r0["program"], r0["reference"], what)
        if leaves:
            top = sorted(leaves.items(), key=lambda kv: -kv[1][0])[:8]
            sys.stderr.write(
                "portbench: %s directions, widest (diff, norm over the "
                "median leaf's): %s\n" % (what, ", ".join(
                    "%s %.4g %.3g" % (n, d, r) for n, (d, r) in top)))
    for name, v in nums.items():
        if "limit" in v:
            sys.stderr.write("check %s %.6g limit %.6g\n"
                             % (name, v["value"], v["limit"]))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
