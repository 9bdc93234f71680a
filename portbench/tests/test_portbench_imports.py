"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``horovod_tpu_torch`` is not ``horovod_tpu``."""

import ast
import json
import os
import subprocess
import sys

import portbench_tiny as tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "horovod_tpu"}
HERE = os.path.join(tiny.REPO, "portbench")


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        if os.sep + "tests" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_top_level_imports(path)) & FORBIDDEN
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_top_level_imports(path))
        assert "horovod_tpu_torch" not in names and not names & FORBIDDEN, \
            (path, names)


_RUN = r"""
import json, sys, tempfile
sys.path.insert(0, %(tests)r)
import portbench_tiny as tiny
from portbench import judge, readers, run, spec, worker
from portbench.tools import check_readers, control
cell = tiny.tiny_cell(tempfile.mkdtemp(), %(cell)r)
for m in cell.per_layer:
    spec.load_reader(m["name"], cell.root)
record = tiny.run_tiny(cell)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = r"""
import json, sys, tempfile
sys.path.insert(0, %(tests)r)
import portbench_tiny as tiny
import torch
from portbench.reference.train import follow
for name in (tiny.LM, tiny.RN):
    cell = tiny.tiny_cell(tempfile.mkdtemp(), name)
    follow(cell.config, cell.traffic, 1, 0, 1, torch.device("cpu"),
           precision="fp8")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code, **kw):
    kw["tests"] = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", code % kw],
                         capture_output=True, text=True, timeout=300,
                         cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """Everything a run of each cell loads, in a process of its own."""
    for cell in (tiny.LM, tiny.RN):
        loaded = _loaded(_RUN, cell=cell)
        assert "horovod_tpu_torch" in loaded and "portbench" in loaded
        assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(_REFERENCE)
    assert "portbench" in loaded
    assert not loaded & (FORBIDDEN | {"horovod_tpu_torch"}), loaded
