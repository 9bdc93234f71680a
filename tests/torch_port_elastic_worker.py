"""A port worker under the JAX package's elastic driver, on the CPU.

Run by tests/test_torch_port_elastic_run.py through ``python -m
horovod_tpu.runner --min-np/--max-np --host-discovery-script``. Imports
torch and horovod_tpu_torch only. Each step makes a named and an unnamed
eager allreduce through ``horovod_tpu_torch.torch`` and one step of a
2-layer, d_model 32 transformer through the bucketed
``DistributedOptimizer`` over gloo, commits, and logs ``{rank, size,
step}`` as one JSON line. At the end every rank gathers the weights and
checks they are equal. Environment (set by the test):

- ``ELASTIC_LOG_DIR``, ``ELASTIC_TOTAL_STEPS``;
- ``ELASTIC_FAIL_RANK`` / ``ELASTIC_FAIL_STEP``: that rank exits once
  (``os._exit(17)``) at that step;
- ``ELASTIC_TRIGGER_FILE`` / ``ELASTIC_TRIGGER_STEP``: rank 0 touches the
  file once it has committed the step (a step-anchored discovery
  change);
- ``ELASTIC_CKPT_DIR`` / ``ELASTIC_CKPT_INTERVAL``: a ``Checkpointer`` on
  the state, so that a cold restart auto-resumes.
"""

import json
import os
import sys
import time

import torch

import horovod_tpu_torch as hvd_p
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import models
from horovod_tpu_torch.utils.checkpoint import Checkpointer

TOTAL_STEPS = int(os.environ.get("ELASTIC_TOTAL_STEPS", "12"))
LOG_DIR = os.environ["ELASTIC_LOG_DIR"]
FAIL_RANK = os.environ.get("ELASTIC_FAIL_RANK")
FAIL_STEP = int(os.environ.get("ELASTIC_FAIL_STEP", "-1"))
FAIL_MARKER = os.path.join(LOG_DIR, "fail_marker")
TRIGGER_FILE = os.environ.get("ELASTIC_TRIGGER_FILE")
TRIGGER_STEP = int(os.environ.get("ELASTIC_TRIGGER_STEP", "-1"))
CKPT_DIR = os.environ.get("ELASTIC_CKPT_DIR")
CKPT_INTERVAL = int(os.environ.get("ELASTIC_CKPT_INTERVAL", "1"))

CFG = models.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq_len=16,
                               dtype=torch.float32, attention="dense")


def log(record):
    path = os.path.join(LOG_DIR, "slot_%s.log" %
                        os.environ["HOROVOD_SLOT_KEY"].replace(":", "_"))
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def batch(step, rank):
    gen = torch.Generator().manual_seed(1000 * step + rank)
    return torch.randint(0, CFG.vocab_size, (2, CFG.max_seq_len),
                         generator=gen)


def flat_weights(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def main():
    hvd.init(device="cpu")
    model = models.Transformer(CFG, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    opt = hvd_p.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-2, weight_decay=1e-4))
    kwargs = {}
    if CKPT_DIR:
        kwargs = dict(checkpointer=Checkpointer(CKPT_DIR, max_to_keep=3),
                      checkpoint_interval=CKPT_INTERVAL)
    state = hvd.elastic.TorchState(model, opt, step=0, **kwargs)

    @hvd.elastic.run
    def train(state):
        while state.step < TOTAL_STEPS:
            step = state.step
            if (FAIL_RANK is not None and hvd.rank() == int(FAIL_RANK)
                    and step == FAIL_STEP
                    and not os.path.exists(FAIL_MARKER)):
                open(FAIL_MARKER, "w").close()
                os._exit(17)
            out = hvd.allreduce(torch.full((4,), float(step)),
                                name="elastic.step", op=hvd.Average)
            assert torch.equal(out, torch.full((4,), float(step)))
            # Unnamed: the auto-names must stay aligned between survivors
            # and fresh respawns (the counters reset at every init).
            ones = hvd.allreduce(torch.ones(2), op=hvd.Sum)
            assert torch.equal(ones, torch.full((2,), float(hvd.size())))
            tokens = batch(step, hvd.rank())
            loss = models.lm_loss(model(tokens), tokens)
            loss.backward()
            opt.step()
            opt.zero_grad()
            state.step = step + 1
            log({"rank": hvd.rank(), "size": hvd.size(),
                 "step": state.step, "loss": float(loss.detach())})
            if (TRIGGER_FILE and hvd.rank() == 0
                    and state.step >= TRIGGER_STEP
                    and not os.path.exists(TRIGGER_FILE)):
                open(TRIGGER_FILE, "w").close()
            time.sleep(0.15)
            state.commit()

    train(state)
    mine = flat_weights(model)
    every = hvd.allgather(mine[None], name="elastic.final")
    for row in every:
        assert torch.equal(row, mine), "the ranks' weights differ"
    log({"rank": hvd.rank(), "size": hvd.size(), "step": state.step,
         "final": True, "checksum": float(mine.double().sum())})
    hvd.shutdown()
    print("ELASTIC_DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
