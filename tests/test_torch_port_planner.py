"""The port's cost model and planner against the reference's.

``horovod_tpu_torch/parallel/costmodel.py`` and ``planner.py`` are pure
Python, as the reference's are, so both run in this process on the same
workload and topology: the candidates (axes, costs, feasibility and
reasons), the choice, the plan's fields, ``summary()``, ``report()`` and
``to_json()`` must be equal exactly, and ``batch_spec`` / ``leaf_spec``
equal to the reference's ``tuple(PartitionSpec)`` entry for entry. The
grid: transformer_long, the MoE transformer and ResNet-50 at their full
widths (parameter counts from the port's models built on the ``meta``
device), and the reference's own test shapes (tests/test_costmodel.py,
tests/test_planner.py), on 1, 2, 4 and 8 devices with dcn 1 and 2, under
the reference's and the H100's fabric figures, given explicitly on both
sides. A plan with no topology takes the H100 data-sheet defaults.
"""

import dataclasses

import pytest
import torch

from horovod_tpu.parallel import costmodel as ref_cm
from horovod_tpu.parallel import planner as ref_planner

from horovod_tpu_torch.parallel import costmodel as cm
from horovod_tpu_torch.parallel import planner

KNOBS = ("HVD_PLAN_ICI_BW_GBPS", "HVD_PLAN_DCN_BW_GBPS",
         "HVD_PLAN_MEM_PER_CHIP_GB", "HVD_PLAN_GRAD_OVERLAP",
         "HVD_WIRE_CODEC", "HVD_GRAD_BUCKET_BYTES")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _model_workloads():
    from horovod_tpu_torch import models

    long_cfg = models.TransformerConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
        max_seq_len=2048, attention="flash")
    out = {}
    for name, cfg, experts in (("transformer_long", long_cfg, 0),
                               ("moe", long_cfg, 4)):
        model = models.Transformer(
            dataclasses.replace(cfg, num_experts=experts), device="meta")
        out[name] = planner.workload_from_params(
            model, batch=4, seq_len=2048, n_layers=4, num_experts=experts,
            dtype_bytes=2)
    out["resnet50"] = planner.workload_from_params(
        models.ResNet50(device="meta"), batch=128, dtype_bytes=2)
    return out


MODELS = _model_workloads()

# The reference's own test shapes (tests/test_costmodel.py,
# tests/test_planner.py) as keyword sets of ``Workload``.
SHAPES = {
    "base": dict(param_bytes=4 << 20, batch=16, seq_len=32, d_model=64,
                 n_layers=2),
    "zero_comm": dict(param_bytes=0, batch=8, seq_len=8, d_model=8,
                      n_layers=0),
    "experts": dict(param_bytes=512 << 20, batch=16, seq_len=1,
                    d_model=63, n_layers=2, num_experts=4,
                    expert_param_bytes=480 << 20),
    "divisibility": dict(param_bytes=1 << 20, batch=6, seq_len=10,
                         d_model=12, n_layers=2),
    "leaf_rules": dict(param_bytes=1 << 30, batch=8, seq_len=32,
                       d_model=1024, n_layers=2),
    "flagship": dict(param_bytes=2 << 20, batch=4, seq_len=32, d_model=64,
                     n_layers=2),
    "pipeline": dict(param_bytes=64 << 20, batch=8, seq_len=64,
                     d_model=256, n_layers=8, pipeline_stages=4),
}
WORKLOADS = sorted(MODELS) + sorted(SHAPES)

TOPOLOGIES = [(c, d) for c in (1, 2, 4, 8) for d in (1, 2) if c % d == 0
              and not (d > 1 and c == 1)]
# (ici GB/s, dcn GB/s, GB per device): the reference's TPU defaults and
# the H100 data-sheet figures.
FABRICS = {"tpu": (90.0, 6.25, 16.0), "h100": (450.0, 50.0, 80.0)}

# Spec probes: expert-leading, model-divisible, indivisible, 1-D, 0-D.
SHAPES_PROBED = [(4, 512, 2048), (4, 63, 128), (512, 4), (1024, 4096),
                 (4096,), (7, 13), (3, 3, 64, 64), ()]


def _workloads(name):
    if name in MODELS:
        w = MODELS[name]
        return w, ref_cm.Workload(*w)
    return cm.Workload(**SHAPES[name]), ref_cm.Workload(**SHAPES[name])


def _topologies(chips, dcn, fabric):
    ici, dcn_bw, mem = FABRICS[fabric]
    args = dict(ici_bw=ici, dcn_bw=dcn_bw, mem_gb=mem)
    return (cm.Topology.make(chips, dcn=dcn, **args),
            ref_cm.Topology.make(chips, dcn=dcn, **args))


def _plans(w, rw, t, rt, require=None):
    """(port plan, reference plan), or the two errors' texts."""
    try:
        mine = planner.plan(workload=w, topology=t, require_axes=require)
    except cm.PlanError as e:
        mine = ("PlanError", str(e))
    try:
        ref = ref_planner.plan(workload=rw, topology=rt,
                               require_axes=require)
    except ref_cm.PlanError as e:
        ref = ("PlanError", str(e))
    return mine, ref


def _same_plan(mine, ref):
    if isinstance(ref, tuple):
        assert mine == ref
        return
    assert mine.mesh_axes == ref.mesh_axes
    assert list(mine.mesh_axes) == list(ref.mesh_axes)
    assert (mine.data_axes, mine.grad_axes, mine.sync, mine.bucket_bytes) \
        == (ref.data_axes, ref.grad_axes, ref.sync, ref.bucket_bytes)
    assert tuple(mine.chosen) == tuple(ref.chosen)
    assert [tuple(c) for c in mine.rejected] == \
        [tuple(c) for c in ref.rejected]
    assert mine.summary() == ref.summary()
    assert mine.report() == ref.report()
    assert mine.to_json() == ref.to_json()
    assert repr(mine) == repr(ref)
    for ndim, seq_dim in ((1, 1), (2, 1), (3, 1), (4, None), (4, 2)):
        assert mine.batch_spec(ndim, seq_dim) == \
            tuple(ref.batch_spec(ndim, seq_dim))
    for shape in SHAPES_PROBED:
        assert mine.leaf_spec(shape) == tuple(ref.leaf_spec(shape)), shape


@pytest.mark.parametrize("fabric", sorted(FABRICS))
@pytest.mark.parametrize("chips,dcn", TOPOLOGIES)
@pytest.mark.parametrize("name", WORKLOADS)
def test_candidates_choice_and_report_are_the_references(name, chips, dcn,
                                                         fabric):
    w, rw = _workloads(name)
    t, rt = _topologies(chips, dcn, fabric)
    assert tuple(t) == tuple(rt)
    cands = cm.enumerate_candidates(w, t)
    ref_cands = ref_cm.enumerate_candidates(rw, rt)
    assert [tuple(c) for c in cands] == [tuple(c) for c in ref_cands]
    for c, rc in zip(cands, ref_cands):
        assert tuple(cm.score(c.axes, w, t)) == \
            tuple(ref_cm.score(rc.axes, rw, rt))
        assert cm.sort_key(c) == ref_cm.sort_key(rc)
    mine, ref = _plans(w, rw, t, rt)
    _same_plan(mine, ref)


REQUIRED = [("moe", 4, 1, {"expert": 2}), ("moe", 4, 1, {"expert": 4}),
            ("moe", 8, 2, {"expert": 2}), ("experts", 8, 1,
                                           {"expert": 4, "data": 2}),
            ("flagship", 8, 1, {"seq": 2, "model": 2}),
            ("flagship", 8, 2, {"model": 2}),
            ("leaf_rules", 8, 1, {"model": 2, "data": 4}),
            ("transformer_long", 4, 2, None),
            ("base", 8, 1, {"bogus": 2}), ("base", 8, 1, {"data": 3})]


@pytest.mark.parametrize("name,chips,dcn,require", REQUIRED)
def test_required_axes_plan_as_the_reference(name, chips, dcn, require):
    w, rw = _workloads(name)
    t, rt = _topologies(chips, dcn, "h100")
    try:
        mine, ref = _plans(w, rw, t, rt, require)
    except ValueError as e:  # an unknown axis: both raise the same
        with pytest.raises(ValueError) as ref_e:
            ref_planner.plan(workload=rw, topology=rt, require_axes=require)
        assert str(e) == str(ref_e.value)
        return
    _same_plan(mine, ref)


def test_the_moe_plans_of_the_card_runs():
    """The 4-card runs' layouts (tests/test_torch_port_plan_cards.py)."""
    w = MODELS["moe"]
    a = planner.plan(workload=w, chips=4, require_axes={"expert": 2})
    assert a.mesh_axes == {"data": 2, "expert": 2}
    assert a.grad_axes == ("data",) and a.sync == "psum"
    b = planner.plan(workload=w, chips=4, require_axes={"expert": 4})
    assert b.mesh_axes == {"data": 1, "expert": 4} and b.sync == "none"
    c = planner.plan(workload=MODELS["transformer_long"],
                     topology=cm.Topology.make(4, dcn=2))
    assert c.mesh_axes == {"data_dcn": 2, "data_ici": 2}
    assert c.sync == "hierarchical"
    assert a.leaf_spec((4, 512, 2048)) == ("expert",)
    assert a.leaf_spec((512, 4)) == ()


def test_a_plan_without_a_topology_takes_the_h100_defaults():
    t = cm.Topology.make(4)
    assert (t.ici_bw_gbps, t.dcn_bw_gbps, t.mem_per_chip_gb) == \
        (450.0, 50.0, 80.0)
    assert (cm.DEFAULT_ICI_BW_GBPS, cm.DEFAULT_DCN_BW_GBPS,
            cm.DEFAULT_MEM_PER_CHIP_GB) == (450.0, 50.0, 80.0)
    p = planner.plan(param_bytes=4 << 20, batch=16, seq_len=32, d_model=64,
                     n_layers=2, chips=8)
    assert p.topology == cm.Topology(8, 8, 1, 450.0, 50.0, 80.0)
    assert "ici 450.0 GB/s, dcn 50.0 GB/s, 80.0 GB/chip" in p.report()
    # Before init, the visible cards (one at least) are the topology.
    q = planner.plan(param_bytes=1 << 20, batch=8)
    assert q.topology.chips == max(torch.cuda.device_count(), 1)


def test_the_knobs_keep_their_names_and_meaning(monkeypatch):
    monkeypatch.setenv("HVD_PLAN_ICI_BW_GBPS", "123")
    monkeypatch.setenv("HVD_PLAN_DCN_BW_GBPS", "7")
    monkeypatch.setenv("HVD_PLAN_MEM_PER_CHIP_GB", "40")
    monkeypatch.setenv("HVD_PLAN_GRAD_OVERLAP", "0.5")
    monkeypatch.setenv("HVD_WIRE_CODEC", "int8")
    t, rt = cm.Topology.make(8, dcn=2), ref_cm.Topology.make(8, dcn=2)
    assert tuple(t) == tuple(rt) == (8, 4, 2, 123.0, 7.0, 40.0)
    assert cm.grad_overlap() == ref_cm.grad_overlap() == 0.5
    assert cm.wire_codec_ratio() == ref_cm.wire_codec_ratio() == 0.26
    for name in ("base", "moe"):
        w, rw = _workloads(name)
        w, rw = w._replace(dtype_bytes=4), rw._replace(dtype_bytes=4)
        _same_plan(*_plans(w, rw, t, rt))


def test_workload_from_params_is_the_references():
    """A small MoE transformer: the port's module against the flax
    model's parameter tree (same names and shapes), and a dict of bf16
    and fp32 tensors against the same jnp arrays."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu import models as ref_models
    from horovod_tpu_torch import models

    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq_len=16, num_experts=4)
    ref_model = ref_models.Transformer(ref_models.TransformerConfig(**kw))
    tokens = jnp.zeros((2, 16), jnp.int32)
    ref_params = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0),
                                tokens)["params"]
    model = models.Transformer(models.TransformerConfig(**kw),
                               device="meta")
    for args in (dict(batch=2, seq_len=16, n_layers=2, num_experts=4),
                 dict(batch=2, num_experts=0, dtype_bytes=2)):
        mine = planner.workload_from_params(model, **args)
        ref = ref_planner.workload_from_params(ref_params, **args)
        assert tuple(mine) == tuple(ref)
    tensors = {"w": torch.zeros(64, 64, dtype=torch.bfloat16),
               "b": torch.zeros(64), "e": {"wi": torch.zeros(4, 8, 16)}}
    arrays = {"w": jnp.zeros((64, 64), jnp.bfloat16),
              "b": jnp.zeros((64,), jnp.float32),
              "e": {"wi": jnp.zeros((4, 8, 16), jnp.float32)}}
    for args in (dict(batch=8), dict(batch=8, num_experts=4),
                 dict(batch=8, dtype_bytes=4, d_model=7)):
        assert tuple(planner.workload_from_params(tensors, **args)) == \
            tuple(ref_planner.workload_from_params(arrays, **args))


def test_leaf_specs_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    p = planner.plan(param_bytes=64 << 20, batch=16, seq_len=1, d_model=63,
                     n_layers=2, num_experts=4, expert_param_bytes=60 << 20,
                     chips=8, require_axes={"expert": 4, "data": 2})
    specs = p.leaf_specs({"wi": torch.zeros(4, 63, 128),
                          "router": [torch.zeros(63, 4)]})
    assert specs == {"wi": ("expert",), "router": [()]}

    class _Mesh:
        mesh_dim_names = ("data", "expert")

    assert planner.placements(p.leaf_spec((4, 63, 128)), _Mesh()) == \
        (Replicate(), Shard(0))
    assert planner.placements(p.batch_spec(2), _Mesh()) == \
        (Shard(0), Replicate())
    h = planner.plan(param_bytes=2 << 20, batch=4, seq_len=32, d_model=64,
                     n_layers=2, chips=8, dcn=2, require_axes={"model": 2})

    class _Mesh3:
        mesh_dim_names = ("data_dcn", "data_ici", "model")

    assert planner.placements(h.batch_spec(2), _Mesh3()) == \
        (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError):
        planner.placements(("model", "model"), _Mesh3())


def test_plan_error_is_the_references():
    w = cm.Workload(param_bytes=8 << 30, batch=8, seq_len=8, d_model=8,
                    n_layers=1)
    rw = ref_cm.Workload(*w)
    t, rt = _topologies(8, 1, "tpu")
    t, rt = t._replace(mem_per_chip_gb=0.5), rt._replace(mem_per_chip_gb=0.5)
    mine, ref = _plans(w, rw, t, rt)
    assert mine[0] == "PlanError" and mine == ref
    assert issubclass(planner.PlanError, ValueError)


def test_the_model_workloads():
    """43.0M fp32 parameters in the MoE transformer, 33.6M of them the
    experts' ``wi`` and ``wo``; 25.6M in ResNet-50."""
    moe = MODELS["moe"]
    assert moe.param_bytes == 4 * 43009024
    assert moe.expert_param_bytes == 4 * 4 * 2 * 4 * 512 * 2048
    assert MODELS["transformer_long"].expert_param_bytes == 0
    assert MODELS["resnet50"].param_bytes == 4 * 25557032
