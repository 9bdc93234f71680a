"""The reference's API that the port lacked: ``init(process_sets=...)``,
the object collectives' ``name``, ``ResNet(act=...)``, ``codec_name`` and
the flat names of ``parallel``, each held to the JAX package.

The np 2 runs go through tests/torch_port_api_worker.py, once with each
package (their native cores export the same symbols, so they never share
a process); at np 1 the port runs in this process. The ResNet holds the
tolerance of tests/test_torch_port_resnet.py against flax in float64. The
reference's ``SURFACE`` lists (tests/test_api_surface.py) run against the
port's modules, apart from the bindings the port leaves out (TensorFlow,
Keras, MXNet and the Lightning estimator).
"""

import importlib
import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

import horovod_tpu_torch as hvd
from horovod_tpu.common import compression as ref_compression
from horovod_tpu_torch import compression
from horovod_tpu_torch.common.process_sets import ProcessSet
from test_api_surface import SURFACE
from test_torch_port_resnet import (
    TOL, _LAUNCHER_ENV, _as_np, _close, _flax, _inputs, _jax_train, _nchw,
    _port, _port_model, _variables,
)
from torch_port_runs import start_runs

from horovod_tpu_torch import models as port

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Bindings and integrations the port does not carry (ROADMAP's port
# scope): TensorFlow, Keras and MXNet, and the Lightning estimator.
OUT_OF_SCOPE = ("horovod_tpu.tensorflow", "horovod_tpu.keras",
                "horovod_tpu.mxnet", "horovod_tpu.spark.lightning")


# ------------------------------------------------------------------ C14 ---

@pytest.mark.parametrize("codec", [None, 0, 1, 2, 3, 4, -1, True, False,
                                   "none", "bf16", "FP16", " int8 ", "3",
                                   "7", "zstd", 2.0, ""])
def test_codec_name_equals_the_reference(codec):
    assert compression.codec_name(codec) == \
        ref_compression.codec_name(codec)


def test_codec_name_inverts_codec_id():
    for name, cid in compression.CODEC_IDS.items():
        assert compression.codec_name(cid) == name
        assert compression.codec_id(compression.codec_name(cid)) == cid


# ------------------------------------------------------------------ C12 ---

@pytest.fixture
def world_of_one(monkeypatch):
    for name in _LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    yield
    hvd.shutdown()


def test_init_registers_process_sets_at_np1(world_of_one):
    """At np 1 the port registers a set over rank 0 (the reference refuses
    a set with the global set's ranks; the port allows it, so that a
    size-1 run can send through the core), then an allreduce in it is the
    identity."""
    mine = ProcessSet([0])
    hvd.init(process_sets=[mine], device="cpu")
    assert mine.process_set_id == 1 and mine.ranks == [0]
    assert hvd.get_process_set_ids() == [0, 1]
    x = torch.arange(5, dtype=torch.float32)
    assert torch.equal(hvd.allreduce(x, name="np1.set", op=hvd.Sum,
                                     process_set=mine), x)


@pytest.fixture(scope="module")
def np2_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api_gaps")
    return start_runs(os.path.join(HERE, "torch_port_api_worker.py"),
                      [((mode,), 2, [mode]) for mode in ("jax", "port")],
                      tmp)


@pytest.mark.parametrize("rank", [0, 1])
def test_np2_process_sets_and_named_objects_equal_the_reference(np2_runs,
                                                                rank):
    ref, got = (json.loads(str(np2_runs[(mode,)][rank]["result"]))
                for mode in ("jax", "port"))
    assert got == ref
    assert got["sets"] == [[1, [1]], [2, [0]]]
    assert got["in_set"] == [float(v + 10 * rank) for v in range(6)]
    assert got["world"] == [float(2 * v + 10) for v in range(6)]
    assert got["broadcast_object"] == repr(
        {"rank": 1, "payload": [0, 1, 2]})


def _flax_gelu(which, jdtype):
    return _flax(which, jdtype).clone(act=nn.gelu)


@pytest.mark.parametrize("which", ["resnet18", "bottleneck"])
def test_resnet_act_matches_flax(which):
    """``act=`` reaches the stem and every block, as flax's does:
    tanh-approximated GELU (flax's ``nn.gelu`` default) against
    ``F.gelu(approximate="tanh")``, train-mode logits, loss and every
    gradient within the ResNet test's fp32 tolerance of flax in float64;
    ReLU's logits differ by far more."""
    act = partial(F.gelu, approximate="tanh")
    model = _port_model(which, torch.float32, act=act)
    images, labels = _inputs()
    variables = _variables(which, images)
    with jax.enable_x64(True):
        loss, logits, _, grads = _jax_train(
            _flax_gelu(which, jnp.float64), _as_np(variables, np.float64),
            images.astype(np.float64), labels)
    _port(model, variables).train()
    out = model(_nchw(images))
    got_loss = F.cross_entropy(out, torch.from_numpy(labels))
    got_loss.backward()
    _close(out.detach().numpy(), logits, what="logits")
    assert abs(got_loss.item() - loss) <= TOL * abs(loss)
    want_grads = port.resnet_from_jax_variables(
        {"params": grads, "batch_stats": variables["batch_stats"]}, model)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), what=name)
    relu = _port(_port_model(which, torch.float32), variables).train()
    with torch.no_grad():
        far = float((relu(_nchw(images)) - out.detach()).abs().max())
    assert far > 100 * TOL * float(np.abs(logits).max())


def test_resnet_default_act_keeps_the_weights():
    """``act`` carries no weight: the state dict's names and shapes are
    those of the default model."""
    a = port.ResNet([1, 1, 1, 1], num_filters=8, num_classes=10,
                    device="cpu")
    b = port.ResNet([1, 1, 1, 1], num_filters=8, num_classes=10,
                    device="cpu", act=partial(F.gelu, approximate="tanh"))
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    assert a.act is F.relu and all(blk.act is F.relu for blk in a.blocks)


# ------------------------------------------------------------------ C13 ---

def _port_name(mod):
    return "horovod_tpu_torch" + mod[len("horovod_tpu"):]


@pytest.mark.parametrize("mod", sorted(m for m in SURFACE
                                       if not m.startswith(OUT_OF_SCOPE)))
def test_reference_surface_on_the_port(mod):
    m = importlib.import_module(_port_name(mod))
    missing = [a for a in SURFACE[mod] if not hasattr(m, a)]
    assert not missing, "%s lacks %r" % (_port_name(mod), missing)


def test_parallel_lazy_modules_on_a_fresh_import():
    """``planner`` and ``costmodel`` resolve on first touch, in a process
    that imported nothing else of the package."""
    code = ("import horovod_tpu_torch.parallel as p, sys; "
            "assert 'horovod_tpu_torch.parallel.planner' not in sys.modules;"
            " assert hasattr(p, 'planner') and hasattr(p, 'costmodel'); "
            "print(p.planner.__name__, p.costmodel.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["horovod_tpu_torch.parallel.planner",
                                  "horovod_tpu_torch.parallel.costmodel"]


def test_parallel_flat_names_are_the_modules():
    from horovod_tpu.parallel import hierarchical as ref_hier
    from horovod_tpu_torch import parallel
    from horovod_tpu_torch.parallel import hierarchical, mesh

    for name in ("DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "EXPERT_AXIS",
                 "PIPE_AXIS"):
        assert getattr(parallel, name) == getattr(mesh, name)
    assert parallel.axis_size is mesh.axis_size
    assert parallel.hierarchical_allreduce is \
        hierarchical.hierarchical_allreduce
    assert parallel.grouped_hierarchical_allreduce is \
        hierarchical.grouped_hierarchical_allreduce
    got = parallel.make_hierarchical_axes(4, 2)
    want = ref_hier.make_hierarchical_axes(4, 2)
    assert got == want and list(got) == list(want)


def test_hierarchical_axes_order_in_the_mesh():
    """``make_mesh`` orders ``data_dcn`` outside ``data_ici`` whatever the
    dict's order."""
    from horovod_tpu_torch.parallel import mesh

    axes = mesh._STANDARD_ORDER
    assert axes.index("data_dcn") < axes.index("data_ici")
    assert list(hvd.parallel.make_hierarchical_axes(2, 3)) == \
        ["data_dcn", "data_ici"]
