"""The device plane across cards: the negotiated eager ops of
``horovod_tpu_torch.torch`` on card tensors (the device plane: NCCL on
process groups of its own, the fusion and Adasum kernels) against the
same ops on host tensors (the native core's TCP ring), at 2 to 4 ranks
with one card each, the card chosen by global rank.

Every value is a small integer, or a multiple of 1/2, so that each sum,
average and product is exact in every dtype and the order in which NCCL
and the ring add does not matter. The matrix: allreduce over the nine
dtypes of the core and its five ops, with and without pre/postscale;
grouped (fused) allreduce; ragged allgather; broadcast; alltoall with
uneven splits; uneven reducescatter; the even and the odd ranks as two
process sets; out-of-order submission; the last rank joined early; and
two steps of the named ``DistributedOptimizer``, after which every rank
must hold the same weights. All of that is bit for bit.

Adasum takes random values (fp32, fp16, bf16, fp64; one tensor with pre-
and postscale, a fused group of ragged tensors, and with the last rank
joined): the plane's fp64 tree sums each tensor's dots in another order
than the ring's sequential sum, so its result is held within one unit in
the last place of the ring's in fp32, fp16 and bf16, and in fp64 to the
forward error bound of a sum of ``count`` terms, ``count * 2^-52`` of
the tensor's largest magnitude.

At four cards a second run lays the ranks out as 2 nodes of 2
(HOROVOD_LOCAL_SIZE=2) with HOROVOD_HIERARCHICAL_ALLREDUCE and
HOROVOD_HIERARCHICAL_ALLGATHER set: the in-graph collectives and the
bucketed optimizer of ``horovod_tpu_torch`` on the two-level ladder equal
the flat ones, and the eager card ops under the flag equal the ring's,
bit for bit on integer values.

This file, run as a script by each rank (``python
test_torch_port_eager_cards.py DEVICE [ladder]``), is the ranks; ``cpu`` rehearses
the flow on host tensors alone. On a machine with two cards or more::

    python3 -m pytest tests/test_torch_port_eager_cards.py -m cuda -q
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DTYPES = [torch.uint8, torch.int8, torch.int32, torch.int64, torch.float16,
          torch.float32, torch.float64, torch.bool, torch.bfloat16]


# ---------------------------------------------------------------- worker ---

def _values(dtype, rank, shape, small=False):
    """Integers 1-7 times (rank + 1); with ``small``, 1 or 2 (products)."""
    n = 1
    for d in shape:
        n *= d
    base = torch.arange(n, dtype=torch.float64).reshape(shape) % 7 + 1
    x = base % 2 + 1 if small else base * (rank + 1)
    if dtype == torch.bool:
        return x.to(torch.int64) % 2 == 0
    return x.to(dtype)


def _flat(result):
    if isinstance(result, (list, tuple)):
        return [t for r in result for t in _flat(r)]
    return [result]


def _same(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.detach().cpu().reshape(-1).view(torch.uint8)
            if x.dtype != torch.bool else x.cpu(),
            y.detach().cpu().reshape(-1).view(torch.uint8)
            if y.dtype != torch.bool else y.cpu())
        for x, y in zip(a, b))


def _ulp_ok(host, card):
    """Adasum's tolerance (see the module's docstring)."""
    from horovod_tpu_torch.ops.adasum import ulp_distance

    host, card = _flat(host), _flat(card)
    if len(host) != len(card):
        return False
    for h, c in zip(host, card):
        c = c.detach().cpu()
        if h.dtype != c.dtype or h.shape != c.shape:
            return False
        if h.dtype == torch.float64:
            bound = h.numel() * 2.0 ** -52 * float(h.abs().max())
            if float((h - c).abs().max()) > bound:
                return False
        elif int(ulp_distance(h, c).max()) > 1:
            return False
    return True


def _card(device):
    """The card of this rank: chosen by global rank, since a layout of
    several nodes on one machine gives two ranks one local rank."""
    if device != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("HOROVOD_RANK", "0")))


def _randn(dtype, rank, shape, seed):
    gen = torch.Generator().manual_seed(1000 * rank + seed)
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)


def _worker_main(device):
    import horovod_tpu_torch.torch as hvd

    card = _card(device)
    hvd.init(device=str(card))
    r, n = hvd.rank(), hvd.size()
    failures = []

    def case(name, fn, same=_same):
        """``fn(device, tag)`` on host tensors, then on card tensors."""
        host = fn(torch.device("cpu"), name + ".host")
        got = fn(card, name + ".card")
        if not same(host, got):
            failures.append(name)

    floats = (torch.float16, torch.float32, torch.float64, torch.bfloat16)
    for dt in DTYPES:
        ops = [hvd.Sum, hvd.Min, hvd.Max, hvd.Product] + (
            [hvd.Average] if dt in floats else [])
        for op in ops:
            small = op == hvd.Product
            case("ar.%s.%d" % (dt, op), lambda d, t: hvd.allreduce(
                _values(dt, r, (3, 5), small).to(d), name=t, op=op))
        case("ar.scaled.%s" % dt, lambda d, t: hvd.allreduce(
            _values(dt, r, (7,)).to(d), name=t, op=hvd.Sum,
            prescale_factor=0.5, postscale_factor=2.0))
        case("grouped.%s" % dt, lambda d, t: hvd.grouped_allreduce(
            [_values(dt, r, (k,)).to(d) for k in (5, 4097, 1)], name=t,
            op=hvd.Average if dt in floats else hvd.Sum))
        case("allgather.%s" % dt, lambda d, t: hvd.allgather(
            _values(dt, r, (r + 1, 3)).to(d), name=t))
        case("broadcast.%s" % dt, lambda d, t: hvd.broadcast(
            _values(dt, r, (4, 2)).to(d), n - 1, name=t))
    for k, dt in enumerate(floats):
        case("adasum.%s" % dt, lambda d, t: hvd.allreduce(
            _randn(dt, r, (3, 5), k).to(d), name=t, op=hvd.Adasum,
            prescale_factor=0.5, postscale_factor=3.0), _ulp_ok)
        case("adasum.grouped.%s" % dt, lambda d, t: hvd.grouped_allreduce(
            [_randn(dt, r, (c,), 10 * k + j).to(d)
             for j, c in enumerate((5, 4097, 1, 300))], name=t,
            op=hvd.Adasum), _ulp_ok)
    splits = [(r + j) % 3 for j in range(n)]
    case("alltoall", lambda d, t: hvd.alltoall(
        _values(torch.float32, r, (sum(splits), 2)).to(d), splits, name=t))
    for op in (hvd.Sum, hvd.Average):
        case("reducescatter.%d" % op, lambda d, t: hvd.reducescatter(
            _values(torch.float32, r, (2 * n + 1, 3)).to(d), op=op,
            name=t))

    # The even and the odd ranks as two sets; every rank registers both.
    sets = [hvd.add_process_set(list(range(k, n, 2))) for k in (0, 1)]
    mine = sets[r % 2]
    case("set.allreduce", lambda d, t: hvd.allreduce(
        _values(torch.float32, r, (6,)).to(d), name=t, op=hvd.Sum,
        process_set=mine))
    case("set.allgather", lambda d, t: hvd.allgather(
        _values(torch.int32, r, (r + 1,)).to(d), name=t, process_set=mine))
    case("set.broadcast", lambda d, t: hvd.broadcast(
        _values(torch.float64, r, (3,)).to(d), mine.ranks[-1], name=t,
        process_set=mine))
    for ps in sets:
        hvd.remove_process_set(ps)

    def out_of_order(d, t):
        a = _values(torch.float32, r, (5,)).to(d)
        b = _values(torch.int64, r, (3,)).to(d)
        if r % 2 == 0:
            ha = hvd.allreduce_async(a, name=t + ".A", op=hvd.Sum)
            hb = hvd.allreduce_async(b, name=t + ".B", op=hvd.Sum)
        else:
            hb = hvd.allreduce_async(b, name=t + ".B", op=hvd.Sum)
            ha = hvd.allreduce_async(a, name=t + ".A", op=hvd.Sum)
        return [hvd.synchronize(hb), hvd.synchronize(ha)]

    case("out_of_order", out_of_order)

    # Two steps of the named optimizer on different data per rank: every
    # rank must end with the same weights.
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4)).to(card)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    gen = torch.Generator().manual_seed(100 + r)
    for _ in range(2):
        model(torch.randn(16, 8, generator=gen).to(card)).pow(2).mean() \
            .backward()
        opt.step()
        opt.zero_grad()
    weights = torch.cat([p.detach().reshape(-1) for p in
                         model.parameters()])
    every = hvd.allgather(weights.reshape(1, -1), name="weights")
    if not all(_same(every[0], row) for row in every):
        failures.append("optimizer weights differ between ranks")

    # The last rank joins at once; the others reduce, with its zeros.
    if r == n - 1:
        last = hvd.join()
    else:
        case("join.allreduce", lambda d, t: hvd.allreduce(
            _values(torch.float32, r, (4,)).to(d), name=t, op=hvd.Sum))
        case("join.adasum", lambda d, t: hvd.allreduce(
            _randn(torch.float32, r, (7, 3), 99).to(d), name=t,
            op=hvd.Adasum), _ulp_ok)
        last = hvd.join()
    if last != n - 1:
        failures.append("join returned %d, want %d" % (last, n - 1))
    hvd.shutdown()
    if failures:
        print("CARDS_FAILED rank %d: %s" % (r, failures))
        return 1
    print("CARDS_OK rank %d of %d on %s" % (r, n, card))
    return 0


def _ladder_main(device):
    """One rank of the 2 x 2 run: the ladder against flat collectives, and
    the eager card ops under the flag against the ring."""
    import horovod_tpu_torch as hvd_g
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.parallel import hierarchical

    card = _card(device)
    hvd.init(device=str(card))
    r = hvd.rank()
    failures = []
    if hierarchical.ladder() is None:
        failures.append("no two-level layout")
    flags = ("HOROVOD_HIERARCHICAL_ALLREDUCE",
             "HOROVOD_HIERARCHICAL_ALLGATHER")

    def in_graph(name, fn):
        """``fn()`` on the ladder, then flat (the flags unset)."""
        ladder = fn()
        saved = {f: os.environ.pop(f) for f in flags}
        try:
            flat = fn()
        finally:
            os.environ.update(saved)
        if not _same(ladder, flat):
            failures.append(name)

    shapes = ((5, 3), (1,), (4097,), (6, 2))
    in_graph("allreduce", lambda: hvd_g.allreduce_ingraph(
        _values(torch.float32, r, (5, 3)).to(card)))
    in_graph("allreduce.sum", lambda: hvd_g.allreduce_ingraph(
        _values(torch.float32, r, (9,)).to(card), hvd_g.Sum))
    in_graph("grouped", lambda: hvd_g.grouped_allreduce_ingraph(
        [_values(torch.float32, r, s).to(card) for s in shapes]))
    in_graph("allgather", lambda: hvd_g.allgather_ingraph(
        _values(torch.float32, r, (r + 1, 2)).to(card)))

    def optimizer_step():
        params = [torch.nn.Parameter(_values(torch.float32, 0, s).to(card))
                  for s in shapes]
        opt = hvd_g.DistributedOptimizer(torch.optim.SGD(params, lr=0.5))
        for p in params:
            p.grad = _values(torch.float32, r, tuple(p.shape)).to(card)
        opt.step()
        return [p.detach() for p in params]

    in_graph("optimizer", optimizer_step)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        host = _values(dt, r, (6, 5))
        got = hvd.allreduce(host.to(card), name="flag.%s" % dt, op=hvd.Sum)
        if not _same(hvd.allreduce(host, name="flag.%s.host" % dt,
                                   op=hvd.Sum), got):
            failures.append("eager allreduce under the flag, %s" % dt)
    xs = [_values(torch.float32, r, s) for s in shapes]
    if not _same(hvd.grouped_allreduce(xs, name="flag.g.host"),
                 hvd.grouped_allreduce([x.to(card) for x in xs],
                                       name="flag.g")):
        failures.append("eager grouped allreduce under the flag")
    hvd.shutdown()
    if failures:
        print("CARDS_FAILED rank %d: %s" % (r, failures))
        return 1
    print("CARDS_OK ladder rank %d on %s" % (r, card))
    return 0


# ----------------------------------------------------------------- tests ---

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n, local_size, what, extra_env=None):
    """Runs this file as ``n`` ranks on the card, ``local_size`` to a
    node; fails the test on any rank's failure."""
    port = str(_free_port())
    procs = []
    for rank in range(n):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank % local_size),
                   HOROVOD_LOCAL_SIZE=str(local_size),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=port,
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "cuda", what],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.mark.cuda
def test_device_plane_equals_the_tcp_ring_across_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more: the device plane's "
                    "NCCL path across ranks")
    n = min(4, torch.cuda.device_count())
    _spawn(n, n, "plane")


@pytest.mark.cuda
def test_hierarchical_ladder_on_nccl_equals_flat():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: 2 nodes of 2 ranks")
    _spawn(4, 2, "ladder", {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                            "HOROVOD_HIERARCHICAL_ALLGATHER": "1"})


if __name__ == "__main__":
    main = _ladder_main if sys.argv[2:] == ["ladder"] else _worker_main
    sys.exit(main(sys.argv[1]))
