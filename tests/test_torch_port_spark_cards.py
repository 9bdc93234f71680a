"""The port's Spark path on four cards, over tests/fake_pyspark.py (each
barrier task a spawned process that takes ``cuda:<local_rank>``)::

    python3 -m pytest tests/test_torch_port_spark_cards.py -m cuda -q -s

- ``spark.run(num_proc=4)``: each task on its own card, a Sum allreduce
  of rank + 1 on the card equal to 10;
- ``TorchEstimator.fit`` through ``SparkBackend(num_proc=4)`` (when pandas
  and pyarrow import): the tiny transformer (fp32, 2 layers, d_model 64,
  flash attention) over 32 rows, batch 2 a rank, against a one-card loop
  over the same global batches (8 rows a step) within ``FIT_TOL``; rank
  0's checkpoint callback reads the core's fusion kernels' and the
  attention kernels' launch counts in its task, which must be above 0;
- ``run_elastic`` with one raised failure on all four ranks ends with the
  uninterrupted run's weights on every rank.

``python tests/test_torch_port_spark_cards.py cpu`` runs the same flows on
the CPU, four gloo processes, to rehearse them without cards.
"""

import functools
import importlib.util
import io
import json
import os
import sys
import tempfile
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CARDS = 4
ROWS = 32
BATCH = 2          # a rank's batch: 8 rows a step over the four ranks
EPOCHS = 2
# The estimator's four ranks average four batch means (NCCL, fp32) where
# the loop takes one mean over the 8 rows: the same sum in another order.
# Measured on the norm of each tensor's difference over the loop's norm.
FIT_TOL = 1e-4

for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


class TinyTokenLM(torch.nn.Module):
    """The tiny transformer over a float matrix of token ids."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, x):
        return self.lm(x.long())


def _train_fn():
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init()
    device = basics.init_device()
    out = hvd.allreduce(torch.full((4,), float(hvd.rank() + 1),
                                   device=device),
                        name="spark_cards_ar", op=hvd.Sum)
    return (hvd.rank(), hvd.size(), device, out.cpu().tolist(),
            "jax" in sys.modules)


def _launches(path, model, epoch):
    """Rank 0's checkpoint callback: the kernels' launch counts so far."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion

    with open("%s.%d.json" % (path, epoch), "w") as f:
        json.dump({"fusion": dict(fusion.LAUNCHES),
                   "attention": {k.__name__: k.launches
                                 for k in fa.KERNELS}}, f)


def flow_run(platform):
    import fake_pyspark
    from horovod_tpu_torch import spark

    fake_pyspark.install()
    try:
        t0 = time.time()
        got = spark.run(_train_fn, num_proc=CARDS, platform=platform)
    finally:
        fake_pyspark.uninstall()
    want_dev = ["cuda:%d" % r if platform == "gpu" else "cpu"
                for r in range(CARDS)]
    assert [(r[0], r[1], r[2]) for r in got] == \
        [(r, CARDS, want_dev[r]) for r in range(CARDS)]
    assert all(r[3] == [10.0] * 4 and not r[4] for r in got)
    print("spark cards: run(num_proc=4) on %s, Sum 10 on each, %.3f s"
          % ([r[2] for r in got], time.time() - t0))


def _tiny_lm(torch, models, device):
    import chip_smoke

    cfg, _, _ = chip_smoke.slice_config(torch, models, tiny=True)
    return TinyTokenLM(models.Transformer(
        cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(chip_smoke.SEED))), cfg


def _rel_norm(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / (b.norm() + 1e-30))


def flow_fit(platform, tmp):
    if any(importlib.util.find_spec(m) is None
           for m in ("pandas", "pyarrow")):
        print("spark cards: the estimator waits for pandas and pyarrow")
        return
    import fake_pyspark
    import pandas as pd

    import chip_smoke
    from horovod_tpu_torch import models
    from horovod_tpu_torch.spark.common import FilesystemStore, SparkBackend
    from horovod_tpu_torch.spark.torch import TorchEstimator

    device = "cuda:0" if platform == "gpu" else "cpu"
    lm, cfg = _tiny_lm(torch, models, device)
    rows = torch.randint(0, cfg.vocab_size, (ROWS, 65),
                         generator=torch.Generator().manual_seed(3)).numpy()
    pdf = pd.DataFrame({"x": list(rows[:, :-1]), "y": list(rows[:, 1:])})
    marks = os.path.join(tmp, "launches")
    store = FilesystemStore(os.path.join(tmp, "store"))
    est = TorchEstimator(
        model=lm, loss=chip_smoke.token_loss,
        optimizer=chip_smoke.spark_adamw, feature_cols=["x"],
        label_cols=["y"], batch_size=BATCH, epochs=EPOCHS, shuffle=False,
        random_seed=0, verbose=0, store=store, run_id="cards",
        checkpoint_callback=functools.partial(_launches, marks),
        backend=SparkBackend(num_proc=CARDS, platform=platform))
    fake_pyspark.install()
    try:
        t0 = time.time()
        fitted = est.fit(pdf)
        fit_s = time.time() - t0
    finally:
        fake_pyspark.uninstall()
    # The one-card loop over the same global batches: step i of an epoch
    # is rows 8i..8i+7 (rank r holds rows r, r+4, ... and takes 2 a step).
    buf = io.BytesIO()
    torch.save(lm, buf)
    model = torch.load(io.BytesIO(buf.getvalue()), weights_only=False,
                       map_location="cpu").to(device)
    torch.manual_seed(0)
    opt = chip_smoke.spark_adamw(model.parameters())
    x = torch.tensor(rows[:, :-1].astype("float32"), device=device)
    y = torch.tensor(rows[:, 1:].astype("float32"), device=device)
    per_step = BATCH * CARDS
    losses = []
    for _ in range(EPOCHS):
        for i in range(ROWS // per_step):
            opt.zero_grad()
            loss = chip_smoke.token_loss(
                model(x[i * per_step:(i + 1) * per_step]),
                y[i * per_step:(i + 1) * per_step])
            loss.backward()
            opt.step()
        losses.append(float(loss.detach()))
    ckpt = torch.load(io.BytesIO(store.read(store.get_checkpoint_path(
        "cards"))), weights_only=False)
    mine = model.state_dict()
    gaps = {k: _rel_norm(ckpt[k], mine[k]) for k in mine}
    with open(marks + ".%d.json" % (EPOCHS - 1)) as f:
        counts = json.load(f)
    print("spark cards: TorchEstimator via SparkBackend(num_proc=4) on %s, "
          "%d rows, batch %d a rank, %d epochs, fit %.3f s; history %s "
          "(rank 0's last batch), the one-card loop %s (8 rows); largest "
          "gap %.3e (%s); rank 0's launches %s"
          % (platform, ROWS, BATCH, EPOCHS, fit_s, fitted.history, losses,
             max(gaps.values()), max(gaps, key=gaps.get), counts))
    assert all(v.device.type == "cpu" for v in ckpt.values())
    assert max(gaps.values()) <= FIT_TOL, gaps
    if platform == "gpu":
        assert counts["fusion"]["fusion_pack"] > 0
        assert counts["fusion"]["fusion_unpack"] > 0
        steps = EPOCHS * ROWS // per_step
        assert all(n == cfg.n_layers * steps
                   for n in counts["attention"].values()), counts


def flow_elastic(platform, tmp):
    import fake_pyspark

    import chip_smoke
    from horovod_tpu_torch import models, spark

    def elastic(fail_step):
        state, model, opt = chip_smoke.spark_elastic_state(torch, models,
                                                           tiny=True)
        return spark.run_elastic(
            chip_smoke.spark_elastic_task,
            args=(state, model, opt, 4, fail_step,
                  os.path.join(tmp, "raised"), True),
            num_proc=CARDS, retries=1, platform=platform)

    fake_pyspark.install()
    try:
        whole = elastic(0)
        t0 = time.time()
        failed = elastic(2)
        failed_s = time.time() - t0
    finally:
        fake_pyspark.uninstall()
    assert [r["started_from"] for r in failed] == [1] * CARDS
    assert [r["generation"] for r in failed] == [2] * CARDS
    assert [r["step"] for r in failed] == [4] * CARDS
    assert [r["device"] for r in failed] == [
        "cuda:%d" % r if platform == "gpu" else "cpu" for r in range(CARDS)]
    assert len({r["checksum"] for r in whole + failed}) == 1
    raised = [float(open(os.path.join(tmp, "raised.%d" % r)).read())
              for r in range(CARDS)]
    print("spark cards: run_elastic(num_proc=4), one raised failure on all "
          "four ranks at step 2: retried from step 1, weights equal to the "
          "uninterrupted run's on every rank; the raise to the retry's "
          "start %s s; the call %.3f s"
          % (["%.3f" % (r["entered"] - t) for r, t in zip(failed, raised)],
             failed_s))


def _need_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        pytest.skip("needs four CUDA cards")


@pytest.mark.cuda
def test_spark_run_takes_a_card_a_task():
    _need_cards()
    flow_run("gpu")


@pytest.mark.cuda
def test_estimator_through_the_spark_backend_on_four_cards(tmp_path):
    _need_cards()
    flow_fit("gpu", str(tmp_path))


@pytest.mark.cuda
def test_run_elastic_recovers_on_four_cards(tmp_path):
    _need_cards()
    flow_elastic("gpu", str(tmp_path))


if __name__ == "__main__":
    if sys.argv[1:] != ["cpu"]:
        sys.exit("usage: python tests/test_torch_port_spark_cards.py cpu")
    with tempfile.TemporaryDirectory() as d:
        flow_run("cpu")
        flow_fit("cpu", d)
        flow_elastic("cpu", d)
