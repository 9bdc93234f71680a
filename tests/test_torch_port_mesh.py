"""The port's mesh, and ``MoeMlp`` with its experts sharded, at np=4 on gloo.

The ranks run tests/torch_port_plan_worker.py (``mesh`` and ``moe``
modes, both runs at once); the reference's side runs in a process of its
own on a 4-device CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

* ``make_mesh`` gives the reference's axis names, in its order, over the
  same layout of ranks as the reference's of devices, and its errors text
  for text; a collective, ``all_to_all``, ``ppermute`` and the bucketed
  optimizer over each axis reduce over that axis's ranks; ``Plan.apply``
  installs the mesh and owns HOROVOD_HIERARCHICAL_ALLREDUCE; ``shutdown``
  forgets the global mesh.
* ``MoeMlp`` in float64 under the planned meshes data 2 x expert 2 and
  data 1 x expert 4 against the reference's ``MoeMlp`` under ``jax.jit``
  with the planner's specs: each rank's output and x gradient, and the
  router's and its experts' gradients summed over the plan's gradient
  set, with tests/test_torch_port_moe.py's tolerances (the gates are
  fp32 on both sides): outputs within ``GATE_RTOL`` = 2^-22, gradients
  within ``MODEL_RTOL`` = 1e-6 of the largest magnitude. The router's
  gradient is the same on every rank of an expert set, bit for bit.
  Under data 2 x expert 2 the port routes each data shard's tokens with
  the capacity of those tokens; the reference's pjit routes the global
  batch. Its inputs drop no token under either capacity, so the two
  agree; data 1 x expert 4 drops tokens and still agrees.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from torch_port_runs import start_runs
from torch_port_plan_worker import (
    B,
    E,
    LAYOUTS,
    MESH_CASES,
    MESH_ERRORS,
    S,
    capacity,
    kept,
    moe_inputs,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_plan_worker.py")
N = 4
GATE_RTOL = 2.0 ** -22
MODEL_RTOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plan_np4")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=ROOT + os.pathsep + HERE)
    ref_out = str(tmp / "ref.npz")
    ref = subprocess.Popen([sys.executable, WORKER, "ref", ref_out],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT)
    got = start_runs(WORKER, [(("mesh",), N, ["mesh"]),
                              (("moe",), N, ["moe"])], tmp,
                     env={"OMP_NUM_THREADS": "1"}, jax=False)
    log = ref.communicate(timeout=240)[0].decode()
    assert ref.returncode == 0, log[-3000:]
    got.ref = dict(np.load(ref_out))
    return got


@pytest.mark.parametrize("case", range(len(MESH_CASES)))
def test_make_mesh_lays_out_axes_as_the_reference(runs, case):
    for r in runs["mesh",]:
        assert list(r["names%d" % case]) == list(runs.ref["names%d" % case])
        np.testing.assert_array_equal(r["grid%d" % case],
                                      runs.ref["grid%d" % case])


@pytest.mark.parametrize("case", range(len(MESH_ERRORS)))
def test_make_mesh_raises_the_references_errors(runs, case):
    want = str(runs.ref["error%d" % case])
    assert want
    for r in runs["mesh",]:
        assert str(r["error%d" % case]) == want


# The mesh {"expert": 2, "data": 2}: data is the outer axis.
AXIS_RANKS = {"data": {0: [0, 2], 1: [1, 3], 2: [0, 2], 3: [1, 3]},
              "expert": {0: [0, 1], 1: [0, 1], 2: [2, 3], 3: [2, 3]}}


@pytest.mark.parametrize("axis", sorted(AXIS_RANKS))
def test_collectives_over_an_axis_reduce_over_its_ranks(runs, axis):
    for rank, r in enumerate(runs["mesh",]):
        ranks = AXIS_RANKS[axis][rank]
        me = ranks.index(rank)
        other = ranks[1 - me]
        assert list(r["ranks_" + axis]) == ranks
        assert r["sum_" + axis].tolist() == [float(sum(ranks) + 2)]
        assert r["gather_" + axis].tolist() == ranks
        # all_to_all: chunk j of member j's tensor, in member order.
        assert r["a2a_" + axis].tolist() == [
            10.0 * ranks[j] + 2 * me + k for j in (0, 1) for k in (0, 1)]
        assert r["perm_" + axis].tolist() == [10.0 * other + k
                                              for k in range(4)]
        assert r["sgd_" + axis].tolist() == [-(sum(ranks) + 2) / 2.0] * 3


def test_axis_sizes_indices_and_placements(runs):
    for rank, r in enumerate(runs["mesh",]):
        assert r["sizes"].tolist() == [2, 2, 1]
        assert r["index"].tolist() == [rank // 2, rank % 2]
        assert bool(r["groups_registered"])
        assert str(r["data_sharding"]) == "(Shard(dim=0), Replicate())"
        assert str(r["data_sharding_seq"]) == "(Shard(dim=0), Shard(dim=1))"
        assert str(r["replicated"]) == "(Replicate(), Replicate())"
        assert "has no axis 'seq'" in str(r["no_axis"])


def test_plan_apply_installs_its_mesh_and_owns_the_ladder_flag(runs):
    for rank, r in enumerate(runs["mesh",]):
        assert list(r["plan_names"]) == ["data", "expert"]
        assert r["plan_grad_ranks"].tolist() == AXIS_RANKS["data"][rank]
        assert str(r["plan_flag"]) == ""
        assert list(r["hier_names"]) == ["data_dcn", "data_ici"]
        assert str(r["hier_flag"]) == "1"
        assert r["hier_grad_ranks"].tolist() == [0, 1, 2, 3]
        assert r["hier_sum"].tolist() == [4.0]
        assert str(r["replan_flag"]) == "unset"
        assert bool(r["after_shutdown"])


def test_the_capacities_and_drops_of_the_moe_inputs():
    """Under e2 no token is dropped at the global batch's capacity nor at
    a data shard's; under e4 (one data shard) tokens are dropped."""
    x, router, *_ = moe_inputs("e2")
    assert kept(x, router, capacity(B * S)) == B * S
    for half in (x[:B // 2], x[B // 2:]):
        assert kept(half, router, capacity(B * S // 2)) == B * S // 2
    x, router, *_ = moe_inputs("e4")
    assert kept(x, router, capacity(B * S)) < B * S


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_a_sharded_block_starts_from_the_unsharded_weights(runs, layout):
    for r in runs["moe",]:
        assert bool(r[layout + ".init_equal"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_moe_output_and_x_gradient_match_the_reference(runs, layout):
    ref = runs.ref
    for r in runs["moe",]:
        lo, hi = r[layout + ".rows"].tolist()
        np.testing.assert_allclose(
            r[layout + ".out"], ref[layout + ".out"][lo:hi],
            rtol=GATE_RTOL, atol=1e-12 * np.abs(ref[layout + ".out"]).max())
        assert _rel(r[layout + ".dx"], ref[layout + ".dx"][lo:hi]) \
            < MODEL_RTOL


@pytest.mark.parametrize("what", ["drouter", "dwi", "dwo"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_moe_parameter_gradients_match_the_reference(runs, layout,
                                                             what):
    ref = runs.ref
    for r in runs["moe",]:
        want = ref[layout + "." + what]
        if what != "drouter":
            first = int(r[layout + ".first"])
            want = want[first:first + r[layout + "." + what].shape[0]]
        assert _rel(r[layout + "." + what], want) < MODEL_RTOL, (layout,
                                                                 what)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_routers_gradient_is_equal_across_expert_ranks(runs, layout):
    ranks = runs["moe",]
    for r in ranks:
        for other in r[layout + ".expert_ranks"].tolist():
            np.testing.assert_array_equal(
                r[layout + ".drouter_local"],
                ranks[other][layout + ".drouter_local"])
    # Averaged over the gradient axes only: data, never expert.
    want = {"e2": [[0, 2], [1, 3]], "e4": [[0], [1], [2], [3]]}[layout]
    assert sorted(r[layout + ".grad_ranks"].tolist() for r in ranks) == \
        sorted(want * (N // len(want)))
    assert E % len(ranks[0][layout + ".expert_ranks"]) == 0
