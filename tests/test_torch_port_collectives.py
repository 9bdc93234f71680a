"""The port's broadcast, allgather, alltoall, reducescatter and state
broadcast at np=2 on gloo, on the global set and on registered process
sets, against numpy and the JAX package.

This file, run as a script by two processes (file rendezvous), is the
two ranks: each saves what every collective returned. The tests hold
the results to numpy, and the layouts of allgather, alltoall and
reducescatter to the reference's in-graph functions
(``horovod_tpu/ops/collective_ops.py``) run on 2 virtual CPU devices with
the same per-rank inputs. Every result must be exact: these collectives
move values, and the sums are of two small integers-valued floats.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _x(rank, shape, dtype=np.float32):
    """Rank-dependent values: rank * 100 + position."""
    return (rank * 100 + np.arange(int(np.prod(shape)))).reshape(
        shape).astype(dtype)


RAGGED_ROWS = (2, 3)          # allgather rows of rank 0 and rank 1
SPLITS = ([1, 2], [3, 0])     # alltoall rows sent to ranks 0 and 1


# ---------------------------------------------------------------- worker ---

def _state_digest(state):
    """(sum, sum of squares) of each tensor, in float64."""
    return {k: np.array([float(v.double().sum()),
                         float(v.double().square().sum())])
            for k, v in state.items()}


def _worker_main(init_file, out_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.ops import collective_ops

    hvd.init(device="cpu", init_method="file://" + init_file)
    rank = hvd.rank()
    out = {}
    t = torch.from_numpy

    out["broadcast"] = hvd.broadcast_ingraph(t(_x(rank, (3, 2))), 1).numpy()
    inplace = t(_x(rank, (4,)))
    same = collective_ops.broadcast_(inplace, 0)
    out["broadcast_inplace"] = inplace.numpy()
    out["broadcast_inplace_is_arg"] = np.array(same is inplace)
    out["broadcast_int"] = hvd.broadcast_ingraph(t(_x(rank, (5,), np.int64)),
                                                 1).numpy()
    out["broadcast_bool"] = hvd.broadcast_ingraph(
        t(_x(rank, (4,)) % 2 == 0), 1).numpy()
    strided = t(_x(rank, (4, 3))).t()
    collective_ops.broadcast_(strided, 1)
    out["broadcast_strided"] = strided.numpy()

    out["allgather"] = hvd.allgather_ingraph(t(_x(rank, (2, 3)))).numpy()
    out["allgather_ragged"] = hvd.allgather_ingraph(
        t(_x(rank, (RAGGED_ROWS[rank], 3)))).numpy()
    try:
        hvd.allgather_ingraph(t(_x(rank, (2, 2 + rank))))
    except ValueError as e:
        out["allgather_mismatch_error"] = np.array(str(e))

    got, splits = hvd.alltoall_ingraph(t(_x(rank, (4, 2))))
    out["alltoall"], out["alltoall_splits"] = got.numpy(), splits.numpy()
    got, splits = hvd.alltoall_ingraph(t(_x(rank, (3, 2))), SPLITS[rank])
    out["alltoall_splits_out"] = got.numpy()
    out["alltoall_splits_recv"] = splits.numpy()
    try:
        hvd.alltoall_ingraph(t(_x(rank, (3, 2))))
    except ValueError as e:
        out["alltoall_error"] = np.array(str(e))

    out["reducescatter_sum"] = hvd.reducescatter_ingraph(t(_x(rank, (4, 3))),
                                                         hvd.Sum).numpy()
    out["reducescatter_average"] = hvd.reducescatter_ingraph(
        t(_x(rank, (4, 3))), hvd.Average).numpy()
    try:
        hvd.reducescatter_ingraph(t(_x(rank, (4, 3))), hvd.Min)
    except ValueError as e:
        out["reducescatter_error"] = np.array(str(e))

    out["broadcast_object"] = np.array(repr(hvd.broadcast_object(
        {"rank": rank, "payload": list(range(rank * 50))}, 1)))
    out["allgather_object"] = np.array(repr(hvd.allgather_object(
        ("rank", rank, "x" * (10 + 1000 * rank)))))
    collective_ops.barrier()

    # A ResNet-18 whose every weight and running statistic differs per
    # rank.
    gen = torch.Generator().manual_seed(10 + rank)
    model = models.ResNet18(num_classes=10, dtype=torch.float32,
                            device="cpu", generator=gen)
    with torch.no_grad():
        for value in model.state_dict().values():
            value.add_(rank + 0.5)
    out["resnet_before"] = _state_digest(model.state_dict())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    out["resnet_after"] = _state_digest(model.state_dict())
    out["resnet_names"] = np.array(sorted(model.state_dict()))

    # Optimizer state: before root's first step, then after it.
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    x = t(_x(rank, (4, 3))) / 100.0
    if rank == 0:
        opt = torch.optim.SGD(net.parameters(), lr=0.1, momentum=0.9)
    else:  # other hyperparameters, and a step already taken
        opt = torch.optim.SGD(net.parameters(), lr=0.5, momentum=0.5)
        net(x).square().sum().backward()
        opt.step()
        opt.zero_grad()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    hvd.broadcast_parameters(net.state_dict(), root_rank=0)
    out["fresh_lr"] = np.array(opt.param_groups[0]["lr"])
    out["fresh_momentum"] = np.array(opt.param_groups[0]["momentum"])
    out["fresh_state_len"] = np.array(len(opt.state))
    if rank == 0:
        net(x).square().sum().backward()
        opt.step()
        opt.zero_grad()
    wrapped = hvd.DistributedOptimizer(opt)
    hvd.broadcast_optimizer_state(wrapped, root_rank=0)
    hvd.broadcast_parameters(net.state_dict(), root_rank=0)
    out["stepped_buffers"] = np.concatenate([
        opt.state[p]["momentum_buffer"].numpy().ravel()
        for p in net.parameters()])
    # The same step on both ranks from the same state and data.
    net(t(_x(0, (4, 3))) / 100.0).square().sum().backward()
    wrapped.step()
    out["after_next_step"] = np.concatenate(
        [p.detach().numpy().ravel() for p in net.parameters()])

    # The in-graph collectives on registered process sets: [0] and [1]
    # (every rank registers both, in the same order), then [0, 1].
    solo = [hvd.add_process_set([k]) for k in range(2)]
    mine = solo[rank]
    out["ps_ids"] = np.array([ps.process_set_id for ps in solo])
    out["ps_solo_average"] = hvd.allreduce_ingraph(
        t(_x(rank, (3,))), hvd.Average, process_set=mine).numpy()
    out["ps_solo_gather"] = hvd.allgather_ingraph(t(_x(rank, (2, 1))),
                                                  process_set=mine).numpy()
    out["ps_solo_object"] = np.array(repr(hvd.broadcast_object(
        ("rank", rank), rank, process_set=mine)))
    try:
        hvd.allreduce_ingraph(t(_x(rank, (3,))), process_set=solo[1 - rank])
    except ValueError as e:
        out["ps_not_member_error"] = np.array(str(e))
    both = hvd.add_process_set(hvd.ProcessSet([0, 1]))
    out["ps_both_average"] = hvd.allreduce_ingraph(
        t(_x(rank, (3,))), hvd.Average, process_set=both).numpy()
    out["ps_both_broadcast"] = hvd.broadcast_ingraph(t(_x(rank, (2,))), 1,
                                                     process_set=both).numpy()
    out["ps_both_reducescatter"] = hvd.reducescatter_ingraph(
        t(_x(rank, (4, 3))), hvd.Sum, process_set=both).numpy()
    out["ps_both_grouped"] = np.concatenate([g.numpy().ravel() for g in (
        hvd.grouped_allreduce_ingraph([t(_x(rank, (2,))), t(_x(rank, (3,)))],
                                      hvd.Sum, process_set=both))])
    out["ps_removed"] = np.array([hvd.remove_process_set(ps)
                                  for ps in solo + [both]])
    hvd.shutdown()
    np.savez(out_path, **{k: v for k, v in out.items()
                          if not isinstance(v, dict)},
             **{"%s.%s" % (k, n): d for k, v in out.items()
                if isinstance(v, dict) for n, d in v.items()})


# ----------------------------------------------------------------- tests ---

@pytest.fixture(scope="module")
def np2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("np2")
    init_file = str(tmp / "rendezvous")
    procs, outs = [], []
    for rank in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        outs.append(str(tmp / ("rank%d.npz" % rank)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             init_file, outs[-1]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(o)) for o in outs]


def test_collectives_on_registered_process_sets(np2):
    """On a set of one rank each collective is that rank's own; on [0, 1]
    they equal the global set's results; a non-member's call raises."""
    both = _x(0, (3,)) + _x(1, (3,))
    rows = (_x(0, (4, 3)) + _x(1, (4, 3)))
    for rank, res in enumerate(np2):
        np.testing.assert_array_equal(res["ps_ids"], [1, 2])
        np.testing.assert_array_equal(res["ps_solo_average"], _x(rank, (3,)))
        np.testing.assert_array_equal(res["ps_solo_gather"],
                                      _x(rank, (2, 1)))
        assert str(res["ps_solo_object"]) == repr(("rank", rank))
        assert "not a member" in str(res["ps_not_member_error"])
        np.testing.assert_array_equal(res["ps_both_average"], both / 2)
        np.testing.assert_array_equal(res["ps_both_broadcast"],
                                      _x(1, (2,)))
        np.testing.assert_array_equal(res["ps_both_reducescatter"],
                                      rows[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(res["ps_both_grouped"], np.concatenate(
            [_x(0, (2,)) + _x(1, (2,)), both]))
        assert res["ps_removed"].all()


def test_broadcast_matches_root(np2):
    for res in np2:
        np.testing.assert_array_equal(res["broadcast"], _x(1, (3, 2)))
        np.testing.assert_array_equal(res["broadcast_inplace"], _x(0, (4,)))
        assert bool(res["broadcast_inplace_is_arg"])
        np.testing.assert_array_equal(res["broadcast_int"],
                                      _x(1, (5,), np.int64))
        np.testing.assert_array_equal(res["broadcast_bool"],
                                      _x(1, (4,)) % 2 == 0)
        np.testing.assert_array_equal(res["broadcast_strided"],
                                      _x(1, (4, 3)).T)


def test_allgather_uniform_and_ragged(np2):
    for res in np2:
        np.testing.assert_array_equal(
            res["allgather"], np.concatenate([_x(r, (2, 3))
                                              for r in range(2)]))
        np.testing.assert_array_equal(
            res["allgather_ragged"],
            np.concatenate([_x(r, (RAGGED_ROWS[r], 3)) for r in range(2)]))
        assert "differ beyond dim 0" in str(res["allgather_mismatch_error"])


def test_alltoall_uniform_and_with_splits(np2):
    for rank, res in enumerate(np2):
        want = np.concatenate([_x(r, (4, 2))[2 * rank:2 * rank + 2]
                               for r in range(2)])
        np.testing.assert_array_equal(res["alltoall"], want)
        np.testing.assert_array_equal(res["alltoall_splits"], [2, 2])
        start = [sum(SPLITS[r][:rank]) for r in range(2)]
        want = np.concatenate([
            _x(r, (3, 2))[start[r]:start[r] + SPLITS[r][rank]]
            for r in range(2)])
        np.testing.assert_array_equal(res["alltoall_splits_out"], want)
        np.testing.assert_array_equal(res["alltoall_splits_recv"],
                                      [SPLITS[r][rank] for r in range(2)])
        assert "not divisible by group size 2" in str(res["alltoall_error"])


def test_reducescatter_sum_average_and_other_ops(np2):
    total = _x(0, (4, 3)) + _x(1, (4, 3))
    for rank, res in enumerate(np2):
        np.testing.assert_array_equal(res["reducescatter_sum"],
                                      total[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(res["reducescatter_average"],
                                      total[2 * rank:2 * rank + 2] / 2)
        assert "supports Sum/Average, got Min" in str(
            res["reducescatter_error"])


def test_objects(np2):
    for res in np2:
        assert str(res["broadcast_object"]) == repr(
            {"rank": 1, "payload": list(range(50))})
        assert str(res["allgather_object"]) == repr(
            [("rank", r, "x" * (10 + 1000 * r)) for r in range(2)])


def test_broadcast_parameters_carries_weights_and_buffers(np2):
    names = list(np2[0]["resnet_names"])
    assert any(n.endswith(".mean") for n in names)
    assert any(n.endswith(".var") for n in names)
    for n in names:
        root = np2[0]["resnet_before.%s" % n]
        assert not np.array_equal(np2[1]["resnet_before.%s" % n], root), n
        for res in np2:
            np.testing.assert_array_equal(res["resnet_after.%s" % n], root)


def test_broadcast_optimizer_state_before_and_after_a_step(np2):
    for res in np2:
        assert float(res["fresh_lr"]) == 0.1
        assert float(res["fresh_momentum"]) == 0.9
        assert int(res["fresh_state_len"]) == 0  # root had not stepped
    np.testing.assert_array_equal(np2[1]["stepped_buffers"],
                                  np2[0]["stepped_buffers"])
    assert np.abs(np2[0]["stepped_buffers"]).max() > 0
    np.testing.assert_array_equal(np2[1]["after_next_step"],
                                  np2[0]["after_next_step"])


# ------------------------------------------------- against the reference ---

def _in_graph(fn, per_rank):
    """The reference's in-graph collective over 2 virtual CPU devices:
    ``per_rank[r]`` is rank r's input; returns each rank's output."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel.mesh import shard_map_compat as shard_map

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    stacked = np.stack(per_rank)
    out = jax.jit(shard_map(lambda s: fn(s[0])[None], mesh=mesh,
                            in_specs=P("data"), out_specs=P("data")))(
        stacked)
    return list(np.asarray(out))


def test_layouts_match_the_reference_in_graph_collectives(np2):
    from horovod_tpu.ops import collective_ops as JC

    cases = {
        "allgather": (lambda s: JC.allgather(s),
                      [_x(r, (2, 3)) for r in range(2)]),
        "alltoall": (lambda s: JC.alltoall(s),
                     [_x(r, (4, 2)) for r in range(2)]),
        "reducescatter_sum": (lambda s: JC.reducescatter(s, op=JC.Sum),
                              [_x(r, (4, 3)) for r in range(2)]),
        "reducescatter_average": (
            lambda s: JC.reducescatter(s, op=JC.Average),
            [_x(r, (4, 3)) for r in range(2)]),
    }
    for name, (fn, inputs) in cases.items():
        for rank, want in enumerate(_in_graph(fn, inputs)):
            np.testing.assert_array_equal(np2[rank][name], want,
                                          err_msg=name)


def test_collectives_check_their_arguments_at_size_one(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
                 "SLURM_PROCID", "SLURM_STEP_NUM_TASKS"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        x = torch.arange(6.0).reshape(3, 2)
        assert hvd.broadcast_object({"a": 1}) == {"a": 1}
        assert hvd.allgather_object(7) == [7]
        assert torch.equal(hvd.allgather_ingraph(x), x)
        with pytest.raises(ValueError, match="root 1"):
            hvd.broadcast_ingraph(x, 1)
        with pytest.raises(ValueError, match="splits"):
            hvd.alltoall_ingraph(x, [2])
        with pytest.raises(ValueError, match="dim 0"):
            hvd.allgather_ingraph(torch.tensor(1.0))
        with pytest.raises(ValueError, match="not registered"):
            hvd.broadcast_ingraph(x, 0, process_set=object())
    finally:
        hvd.shutdown()


def test_process_set_queries_and_check_extension(monkeypatch):
    """get_process_set_ids, get_process_set and check_extension, as the
    JAX package has them (common/process_sets.py:139-146,
    common/basics.py:434)."""
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_t

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
                 "SLURM_PROCID", "SLURM_STEP_NUM_TASKS"):
        monkeypatch.delenv(name, raising=False)
    hvd_t.check_extension()
    hvd_t.check_extension("horovod.torch", "HOROVOD_WITH_PYTORCH", __file__)
    hvd.init(device="cpu")
    try:
        assert hvd.get_process_set_ids() == [0]
        assert hvd.get_process_set(0) is hvd.global_process_set
        ps = hvd_t.add_process_set([0])
        ps_id = ps.process_set_id
        assert hvd_t.get_process_set_ids() == [0, ps_id]
        assert hvd_t.get_process_set(ps_id) is ps
        hvd.remove_process_set(ps)
        assert hvd.get_process_set_ids() == [0]
        with pytest.raises(KeyError):
            hvd.get_process_set(ps_id)
    finally:
        hvd.shutdown()


def test_size_one_core_takes_no_port(monkeypatch):
    """At size 1 the native core opens no socket, so ``init`` hands it no
    port and size-1 processes on one machine cannot race for one: it
    starts, and runs an eager allreduce, while the port named in
    HOROVOD_CONTROLLER_PORT is held by another socket."""
    import socket

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_t
    from horovod_tpu_torch.common import basics

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
                 "SLURM_PROCID", "SLURM_STEP_NUM_TASKS",
                 "HOROVOD_CONTROLLER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen(1)
        monkeypatch.setenv("HOROVOD_CONTROLLER_PORT",
                           str(held.getsockname()[1]))
        topo = basics._topology_from_env()
        assert basics._core_address(topo) == ("127.0.0.1", 0)
        hvd.init(device="cpu")
        try:
            x = torch.arange(6.0).reshape(3, 2)
            assert torch.equal(hvd_t.allreduce(x, name="no_port.x"), x)
        finally:
            hvd.shutdown()


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
