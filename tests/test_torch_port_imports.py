"""horovod_tpu_torch imports neither JAX nor horovod_tpu.

Every module of the package, and chip_smoke.py, is imported in a fresh
interpreter; afterwards no ``jax``/``flax``/``optax``/``horovod_tpu``
module may be loaded.
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
                "horovod_tpu_torch.models.mnist"):
        assert mod in result["modules"]
