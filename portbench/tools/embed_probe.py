"""Where the language model's embedding gradient departs from the
reference's, at the cell's own size, one step from the seed's weights.

    python3 portbench/tools/embed_probe.py --workload NAME --seeds 1 2 3

The embedding is tied: its gradient is the gather's backward (a sum over
every position of a token id) plus the logits' product. For each seed it
prints, against the float32 reference's gradient of the same leaf
(gap: |norm - reference's| / reference's; diff: |g - reference| /
reference's, over the whole leaf and over the most frequent id's row):

- ``program``: the program's ``.grad`` after ``loss.backward()``;
- ``optimizer``: the gradient as ``DistributedOptimizer(AdamW)`` got it at
  its first step (the first moment over 1 - beta1), as a run reads it;
- ``fp32_gather``: the program's ``.grad`` with its gather's backward
  summed again in float32 from the program's own gradient at the gather's
  output (captured at the first block's input), in place of the bfloat16
  sum the program makes;
- ``gather_bf16_vs_fp32``: the two sums of the gather's backward alone.

One JSON line a seed on standard output."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import feed, script, spec, weights  # noqa: E402
from portbench.reference import lm  # noqa: E402
from portbench.reference.common import Ops, exact  # noqa: E402


def _gap(a, r) -> float:
    na, nr = float(a.norm()), float(r.norm())
    return abs(na - nr) / nr


def _diff(a, r) -> float:
    return float((a - r).norm()) / float(r.norm())


def program_side(cell, seed, hvd, models, dev):
    cfg, traffic = cell.config, cell.traffic
    model = script.build_model(models, cfg, traffic, dev)
    model.load_state_dict(weights.make(cfg, seed, dev))
    model.train()
    x, y = feed.batch(traffic, cfg, seed, 0, 0, dev)
    seen = {}

    def capture(module, args):
        inp = args[0]
        seen["dx"] = inp
        inp.register_hook(lambda g: seen.__setitem__("g", g.detach()))
        handle.remove()
        return None

    handle = model.layers[0].register_forward_pre_hook(capture)
    loss = models.lm_loss(model(x), x, y)
    loss.backward()
    g_prog = model.embed.grad.detach().clone()
    dx = seen["g"].reshape(-1, cfg["n_embd"])
    ids = x.reshape(-1)
    import torch

    g16 = torch.zeros(model.embed.shape, dtype=dx.dtype, device=dev)
    g16.index_put_((ids,), dx, accumulate=True)
    g32 = torch.zeros(model.embed.shape, dtype=torch.float32, device=dev)
    g32.index_put_((ids,), dx.float(), accumulate=True)
    g_fixed = g_prog - g16.float() + g32
    top = int(torch.bincount(ids).argmax())
    model.zero_grad(set_to_none=True)
    opt_cfg = traffic["optimizer"]
    inner = script.build_optimizer(model.parameters(), opt_cfg)
    opt = hvd.DistributedOptimizer(inner)
    loss2 = models.lm_loss(model(x), x, y)
    loss2.backward()
    opt.step()
    g_opt = script.first_gradient(inner, model.embed).detach().clone()
    out = {"loss": float(loss.detach()), "top_id": top,
           "top_count": int((ids == top).sum()),
           "sides": {"program": g_prog, "optimizer": g_opt,
                     "fp32_gather": g_fixed},
           "gather": (g16.float(), g32)}
    del model, inner, opt, seen
    return out


def reference_side(cell, seed, dev):
    import torch

    cfg = cell.config
    W = weights.make(cfg, seed, dev)
    W["embed"].requires_grad_(True)
    x, y = feed.batch(cell.traffic, cfg, seed, 0, 0, dev)
    with exact():
        lm.accumulate(W, cfg, x, y, Ops("fp32"))
    g = W["embed"].grad / float(y.numel())
    del W
    torch.cuda.empty_cache()
    return g


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.common.basics import init_device

    hvd.init()
    dev = torch.device(init_device())
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        t = time.time()
        got = program_side(cell, seed, hvd, models, dev)
        torch.cuda.empty_cache()
        ref = reference_side(cell, seed, dev)
        top = got["top_id"]
        line = {"workload": cell.name, "seed": seed, "loss": got["loss"],
                "top_id": top, "top_count": got["top_count"]}
        for name, g in got["sides"].items():
            line[name] = {"gap": _gap(g, ref), "diff": _diff(g, ref),
                          "top_row_gap": _gap(g[top], ref[top]),
                          "top_row_diff": _diff(g[top], ref[top])}
        g16, g32 = got["gather"]
        line["gather_bf16_vs_fp32"] = {
            "gap": _gap(g16, g32), "diff": _diff(g16, g32),
            "top_row_gap": _gap(g16[top], g32[top]),
            "share_of_leaf_norm": float(g32.norm()) / float(ref.norm())}
        line["seconds"] = time.time() - t
        print(json.dumps(line), flush=True)
        del got, ref, g16, g32
        torch.cuda.empty_cache()
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
