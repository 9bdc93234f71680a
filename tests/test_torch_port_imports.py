"""horovod_tpu_torch imports neither JAX nor horovod_tpu.

Every module of the package, and chip_smoke.py, is imported in a fresh
interpreter; afterwards no ``jax``/``flax``/``optax``/``horovod_tpu``
module may be loaded. The launcher's paths (``python -m
horovod_tpu_torch.runner``, its elastic driver, ``--check-build``, the
root's ``run``, ``horovod_tpu_torch.ray``) import no package outside
PyTorch's installation at module level: not psutil, cloudpickle, PyYAML
or ray. The Spark port (``horovod_tpu_torch.spark`` and its modules) and
``horovod_tpu_torch.introspect`` import none of pandas, pyarrow, pyspark
or cloudpickle at module level: each is imported where it is used.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import horovod_tpu_torch
names = ["horovod_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                          "horovod_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "horovod_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


_LAUNCHER_PROBE = r"""
import io, json, sys
import horovod_tpu_torch
from horovod_tpu_torch import runner
from horovod_tpu_torch.runner import (
    __main__, discovery, driver_service, elastic_run, exec_util, hosts,
    launch, mpi_run, js_run, network, safe_shell_exec)
import horovod_tpu_torch.ray
from horovod_tpu_torch.ray import elastic, strategy, utils
launch.parse_args(["-np", "2", "python", "train.py"])
launch.check_build(io.StringIO())
horovod_tpu_torch.run
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "horovod_tpu", "psutil", "cloudpickle",
                                    "yaml", "ray"))
print(json.dumps({"bad": bad}))
"""


_SPARK_MODULES = (
    "horovod_tpu_torch.spark",
    "horovod_tpu_torch.spark.common",
    "horovod_tpu_torch.spark.common.util",
    "horovod_tpu_torch.spark.common.params",
    "horovod_tpu_torch.spark.common.store",
    "horovod_tpu_torch.spark.common.convert",
    "horovod_tpu_torch.spark.common.backend",
    "horovod_tpu_torch.spark.common.estimator",
    "horovod_tpu_torch.spark.data_loaders",
    "horovod_tpu_torch.spark.torch",
    "horovod_tpu_torch.introspect",
)

_SPARK_PROBE = r"""
import importlib, json, sys
for n in %r:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "horovod_tpu", "pandas", "pyarrow",
                                    "pyspark", "cloudpickle"))
print(json.dumps({"bad": bad}))
""" % (_SPARK_MODULES,)


_TUNER_PROBE = r"""
import json, sys
import horovod_tpu_torch.ops.block_tuner
import horovod_tpu_torch.parallel.hierarchical
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "horovod_tpu"))
print(json.dumps({"bad": bad}))
"""


def test_the_tile_tuner_and_the_ladder_import_no_jax():
    """``ops/block_tuner.py`` and ``parallel/hierarchical.py`` (with
    ``make_hierarchical_axes``), each the port of a reference module,
    imported first in a fresh interpreter: no JAX, no ``horovod_tpu``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _TUNER_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []


def test_the_spark_port_imports_no_optional_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _SPARK_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []


def test_the_launchers_paths_import_no_optional_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _LAUNCHER_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for mod in ("horovod_tpu_torch.common.basics",
                "horovod_tpu_torch.common.objects",
                "horovod_tpu_torch.functions",
                "horovod_tpu_torch.optimizer",
                "horovod_tpu_torch.sync_batch_norm",
                "horovod_tpu_torch.ops.flash_attention",
                "horovod_tpu_torch.models.transformer",
                "horovod_tpu_torch.models.resnet",
                "horovod_tpu_torch.models.mnist",
                "horovod_tpu_torch.core.build",
                "horovod_tpu_torch.core.session",
                "horovod_tpu_torch.core.device_plane",
                "horovod_tpu_torch.ops.eager",
                "horovod_tpu_torch.ops.fusion",
                "horovod_tpu_torch.torch",
                "horovod_tpu_torch.torch.mpi_ops",
                "horovod_tpu_torch.torch.functions",
                "horovod_tpu_torch.torch.compression",
                "horovod_tpu_torch.torch.optimizer",
                "horovod_tpu_torch.torch.sync_batch_norm",
                "horovod_tpu_torch.parallel.adasum",
                "horovod_tpu_torch.parallel.hierarchical",
                "horovod_tpu_torch.ops.adasum",
                "horovod_tpu_torch.ops.codec",
                "horovod_tpu_torch.parallel.mesh",
                "horovod_tpu_torch.parallel.sequence",
                "horovod_tpu_torch.parallel.moe",
                "horovod_tpu_torch.parallel.pipeline",
                "horovod_tpu_torch.common.util",
                "horovod_tpu_torch.common.failure",
                "horovod_tpu_torch.runner.http_server",
                "horovod_tpu_torch.elastic",
                "horovod_tpu_torch.elastic.state",
                "horovod_tpu_torch.elastic.worker",
                "horovod_tpu_torch.utils.checkpoint",
                "horovod_tpu_torch.data.sampler",
                "horovod_tpu_torch.data.data_loader",
                "horovod_tpu_torch.torch.elastic",
                "horovod_tpu_torch.utils.metrics",
                "horovod_tpu_torch.utils.flightrec",
                "horovod_tpu_torch.utils.timeline",
                "horovod_tpu_torch.utils.autotune",
                "horovod_tpu_torch.utils.online_tuner",
                "horovod_tpu_torch.common.knobs",
                "horovod_tpu_torch.common.fault_injection",
                "horovod_tpu_torch.runner.journal",
                "horovod_tpu_torch.parallel.costmodel",
                "horovod_tpu_torch.parallel.planner",
                "horovod_tpu_torch.serve",
                "horovod_tpu_torch.serve.batching",
                "horovod_tpu_torch.serve.replica",
                "horovod_tpu_torch.serve.router",
                "horovod_tpu_torch.serve.standby",
                "horovod_tpu_torch.serve.rollout",
                "horovod_tpu_torch.serve.autoscale",
                "horovod_tpu_torch.serve.server",
                "horovod_tpu_torch.serve.__main__",
                "horovod_tpu_torch.runner",
                "horovod_tpu_torch.runner.__main__",
                "horovod_tpu_torch.runner.hosts",
                "horovod_tpu_torch.runner.network",
                "horovod_tpu_torch.runner.safe_shell_exec",
                "horovod_tpu_torch.runner.exec_util",
                "horovod_tpu_torch.runner.driver_service",
                "horovod_tpu_torch.runner.discovery",
                "horovod_tpu_torch.runner.launch",
                "horovod_tpu_torch.runner.mpi_run",
                "horovod_tpu_torch.runner.js_run",
                "horovod_tpu_torch.runner.elastic_run",
                "horovod_tpu_torch.ray",
                "horovod_tpu_torch.ray.utils",
                "horovod_tpu_torch.ray.strategy",
                "horovod_tpu_torch.ray.elastic") + _SPARK_MODULES:
        assert mod in result["modules"]
