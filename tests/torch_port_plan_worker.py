"""One rank of the port's mesh and sharded-MoE runs, or the reference's side.

``python torch_port_plan_worker.py MODE OUT`` under the launcher's
environment (tests/torch_port_runs.py ``start_runs``), on gloo:

* ``mesh`` (np=4): ``make_mesh``'s axis order, its errors, a collective,
  ``all_to_all``, ``ppermute`` and the bucketed optimizer over each axis,
  the DTensor placements, ``Plan.apply`` and its gradient set, and that
  ``shutdown`` forgets the global mesh;
* ``moe`` (np=4): ``MoeMlp`` in float64 under two planned meshes, data 2 x
  expert 2 and data 1 x expert 4: this rank's output and the gradients of
  x, the router, and its experts' ``wi`` and ``wo``, each summed over the
  plan's gradient set as the optimizer's allreduce would (before the sum,
  the router's gradient as this rank computed it);
* ``ref`` (one process, ``XLA_FLAGS=--xla_force_host_platform_device_count=4``):
  the reference's ``MoeMlp`` under ``jax.jit`` on a 4-device CPU mesh with
  the planner's specs for the same two layouts, and ``make_mesh``'s axis
  orders and errors.

Each writes its results to OUT (.npz).
"""

import os
import sys

import numpy as np

B, S, M, F, E = 4, 8, 16, 32, 4
LAYOUTS = {"e2": {"expert": 2}, "e4": {"expert": 4}}
# The router's scale and the inputs' offset per layout: under e2 a small
# router, so that no expert overflows its capacity in either package (the
# reference routes the global batch, the port each data shard; with no
# drop the two agree); under e4, whose data axis is 1, inputs and a router
# that favour expert 0, so that its capacity drops tokens and the
# comparison covers it.
ROUTER_SCALE = {"e2": 0.02, "e4": 1.0}
FAVOUR = {"e2": 0.0, "e4": 1.0}
MESH_CASES = [{"model": 2, "data": 2}, {"expert": 2, "data_dcn": 2},
              {"foo": 2, "data": 2}, {"seq": -1, "pipe": 2}, None]
MESH_ERRORS = [{"data": -1, "expert": -1}, {"data": 3},
               {"data": -1, "expert": 3}]


def moe_inputs(layout, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, M) + FAVOUR[layout]
    router = rng.randn(M, E) * ROUTER_SCALE[layout]
    router[:, 0] += FAVOUR[layout]
    wi = rng.randn(E, M, F) * 0.1
    wo = rng.randn(E, F, M) * 0.1
    dout = rng.randn(B, S, M)
    return x, router, wi, wo, dout


def capacity(tokens):
    return max(1, int(2 * tokens // E))


def kept(x, router, cap):
    """Tokens that fit their expert's queue (top-1 on the logits)."""
    t = x.reshape(-1, M)
    expert = (t @ router).argmax(-1)
    counts = np.zeros(E, int)
    keep = 0
    for e in expert:
        keep += counts[e] < cap
        counts[e] += 1
    return keep


def _workload():
    from horovod_tpu_torch.parallel.costmodel import Workload

    return Workload(param_bytes=4 * (M * E + 2 * E * M * F), batch=B,
                    seq_len=S, d_model=M, n_layers=1, num_experts=E,
                    expert_param_bytes=4 * 2 * E * M * F)


# ------------------------------------------------------------- the port ---


def mesh_mode(out):
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.parallel import mesh, planner

    hvd.init(device="cpu")
    rank = hvd.rank()
    res = {}
    for i, sizes in enumerate(MESH_CASES):
        m = hvd.make_mesh(sizes)
        res["names%d" % i] = np.array(m.mesh_dim_names)
        res["grid%d" % i] = m.mesh.numpy()
    for i, sizes in enumerate(MESH_ERRORS):
        try:
            hvd.make_mesh(sizes)
            res["error%d" % i] = np.array("")
        except ValueError as e:
            res["error%d" % i] = np.array(str(e))
    m = hvd.make_mesh({"expert": 2, "data": 2})
    hvd.set_global_mesh(m)
    assert hvd.global_mesh() is m and mesh.installed_mesh() is m
    names = [str(n) for n in m.mesh_dim_names]
    res["sizes"] = np.array([mesh.axis_size(a) for a in
                             ("data", "expert", "seq")])
    res["index"] = np.array([mesh.axis_index(a) for a in names])
    # The DeviceMesh's groups are the world's, which abort_groups walks.
    pgs = dist.distributed_c10d._world.pg_names
    res["groups_registered"] = np.array(all(
        m.get_group(a) in pgs for a in names))
    res["data_sharding"] = np.array(repr(mesh.data_sharding()))
    res["data_sharding_seq"] = np.array(repr(mesh.data_sharding(
        None, "expert")))
    res["replicated"] = np.array(repr(mesh.replicated()))
    for axis in names:
        ps = mesh.axis_set(axis)
        res["ranks_" + axis] = np.array(ps.ranks)
        x = torch.tensor([float(rank + 1)])
        res["sum_" + axis] = C.allreduce(x, C.Sum, process_set=ps).numpy()
        res["gather_" + axis] = C.allgather(
            torch.tensor([rank]), process_set=ps).numpy()
        y = torch.arange(4.0) + 10 * rank
        res["a2a_" + axis] = mesh.all_to_all(y, 0, 0, axis).numpy()
        res["perm_" + axis] = mesh.ppermute(y, [(0, 1), (1, 0)],
                                            axis).numpy()
        w = torch.nn.Parameter(torch.zeros(3))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                       process_set=ps)
        (w * (rank + 1)).sum().backward()
        opt.step()
        res["sgd_" + axis] = w.detach().numpy()
    try:
        mesh.axis_set("seq")
    except ValueError as e:
        res["no_axis"] = np.array(str(e))
    # A plan: apply installs its mesh and names the gradient set.
    p = planner.plan(workload=_workload(), require_axes={"expert": 2})
    pm = p.apply()
    res["plan_names"] = np.array(pm.mesh_dim_names)
    res["plan_grad_ranks"] = np.array(p.grad_process_set().ranks)
    res["plan_flag"] = np.array(os.environ.get(
        "HOROVOD_HIERARCHICAL_ALLREDUCE", ""))
    h = planner.plan(workload=_workload(),
                     topology=planner.Topology.make(4, dcn=2))
    hm = h.apply()
    res["hier_names"] = np.array(hm.mesh_dim_names)
    res["hier_flag"] = np.array(os.environ.get(
        "HOROVOD_HIERARCHICAL_ALLREDUCE", ""))
    res["hier_grad_ranks"] = np.array(h.grad_process_set().ranks)
    res["hier_sum"] = C.allreduce(torch.tensor([1.0]), C.Sum,
                                  process_set=h.grad_process_set()).numpy()
    p.apply()
    res["replan_flag"] = np.array(os.environ.get(
        "HOROVOD_HIERARCHICAL_ALLREDUCE", "unset"))
    hvd.shutdown()
    res["after_shutdown"] = np.array(mesh.installed_mesh() is None)
    np.savez(out, **res)


def moe_mode(out):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.parallel import mesh, moe, planner

    hvd.init(device="cpu")
    rank = hvd.rank()
    res = {}
    cfg = models.TransformerConfig(d_model=M, d_ff=F, num_experts=E,
                                   n_heads=2, dtype=torch.float64)
    whole = moe.MoeMlp(cfg, torch.Generator().manual_seed(0), "cpu")
    assert whole.expert_set is None
    for name, require in LAYOUTS.items():
        p = planner.plan(workload=_workload(), require_axes=require)
        p.apply()
        block = moe.MoeMlp(cfg, torch.Generator().manual_seed(0), "cpu")
        assert block.expert_set is not None
        n = mesh.axis_size("expert")
        first = mesh.axis_index("expert") * (E // n)
        # Drawn in full and sliced: the unsharded block's weights.
        res[name + ".init_equal"] = np.array(
            torch.equal(block.router, whole.router)
            and torch.equal(block.wi, whole.wi[first:first + E // n])
            and torch.equal(block.wo, whole.wo[first:first + E // n]))
        x, router, wi, wo, dout = moe_inputs(name)
        d = mesh.axis_size("data")
        rows = slice(mesh.axis_index("data") * (B // d),
                     (mesh.axis_index("data") + 1) * (B // d))
        with torch.no_grad():
            block.double()
            block.router.copy_(torch.tensor(router))
            block.wi.copy_(torch.tensor(wi[first:first + E // n]))
            block.wo.copy_(torch.tensor(wo[first:first + E // n]))
        xs = torch.tensor(x[rows]).requires_grad_()
        y = block(xs)
        (y * torch.tensor(dout[rows])).sum().backward()
        grads = p.grad_process_set()
        res[name + ".out"] = y.detach().numpy()
        res[name + ".rows"] = np.array([rows.start, rows.stop])
        res[name + ".first"] = np.array(first)
        res[name + ".dx"] = xs.grad.numpy()
        res[name + ".drouter_local"] = block.router.grad.numpy()
        for what, g in (("drouter", block.router.grad),
                        ("dwi", block.wi.grad), ("dwo", block.wo.grad)):
            res[name + "." + what] = C.allreduce(
                g, C.Sum, process_set=grads).numpy()
        res[name + ".grad_ranks"] = np.array(grads.ranks)
        res[name + ".expert_ranks"] = np.array(
            mesh.axis_set("expert").ranks)
    hvd.shutdown()
    np.savez(out, **res)


# -------------------------------------------------------- the reference ---


def ref_mode(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from horovod_tpu import models as ref_models
    from horovod_tpu.parallel import mesh as ref_mesh
    from horovod_tpu.parallel import moe as ref_moe
    from horovod_tpu.parallel import planner as ref_planner
    from horovod_tpu.parallel.costmodel import Workload

    devices = jax.devices()
    assert len(devices) == 4, devices
    res = {}
    for i, sizes in enumerate(MESH_CASES):
        m = ref_mesh.make_mesh(sizes)
        res["names%d" % i] = np.array(m.axis_names)
        res["grid%d" % i] = np.vectorize(lambda d: d.id)(m.devices)
    for i, sizes in enumerate(MESH_ERRORS):
        try:
            ref_mesh.make_mesh(sizes)
            res["error%d" % i] = np.array("")
        except ValueError as e:
            res["error%d" % i] = np.array(str(e))
    w = Workload(param_bytes=4 * (M * E + 2 * E * M * F), batch=B,
                 seq_len=S, d_model=M, n_layers=1, num_experts=E,
                 expert_param_bytes=4 * 2 * E * M * F)
    with jax.enable_x64(True):
        cfg = ref_models.TransformerConfig(d_model=M, d_ff=F,
                                           num_experts=E, n_heads=2,
                                           dtype=jnp.float64)
        block = ref_moe.MoeMlp(cfg)
        for name, require in LAYOUTS.items():
            p = ref_planner.plan(workload=w, topology=None, chips=4,
                                 require_axes=require)
            m = ref_mesh.make_mesh(p.mesh_axes)
            x, router, wi, wo, dout = (jnp.asarray(a)
                                       for a in moe_inputs(name))
            params = {"router": router, "wi": wi, "wo": wo}
            specs = {k: NamedSharding(m, p.leaf_spec(v.shape))
                     for k, v in params.items()}
            batch = NamedSharding(m, p.batch_spec(3, seq_dim=None))

            def loss(params, x, dout):
                y = block.apply({"params": params}, x)
                return (y * dout).sum(), y

            fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True),
                         in_shardings=(specs, batch, batch))
            (_, y), (g, gx) = fn(params, x, dout)
            res[name + ".out"] = np.asarray(y)
            res[name + ".dx"] = np.asarray(gx)
            for k in params:
                res[name + ".d" + k] = np.asarray(g[k])
            res[name + ".specs"] = np.array(repr(
                {k: tuple(p.leaf_spec(v.shape)) for k, v in
                 params.items()}))
    np.savez(out, **res)


def main(mode, out):
    {"mesh": mesh_mode, "moe": moe_mode, "ref": ref_mode}[mode](out)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
