"""How well-conditioned the port's ResNet parity checks are, on the CPU.

Prints the numbers that set the tolerances of
``tests/test_torch_port_resnet.py`` and of ``chip_smoke.py``'s ResNet
checks, each as the worst elementwise error over a tensor divided by
that tensor's largest magnitude (the tests' ``_close`` measure):

1. fp32 ResNet-18 gradients against flax's float64 ones: XLA:CPU's
   (jitted) and the port's, with torch's oneDNN convolutions on and
   off, at batch 8, 64px, seed 0 and at batch 2, 32px, seeds 0 and 5;
2. the port's fp32 gradients against flax in float64 at the tests'
   inputs (batch 8, 32px, seeds 0-3, both configurations);
3. bf16 logits of the port and of flax against the float64 logits, and
   against each other (batch 4, 64px, seeds 0-2);
4. ``chip_smoke.py``'s reduced ResNet (bottleneck, 16 filters, 100
   classes, batch 4, 64px, seed 2): the port's fp32 step against the
   port's float64 step, and ``SyncBatchNorm`` against the plain batch
   norm at size 1 (gloo).

Run from the repo root (a few minutes)::

    JAX_PLATFORMS=cpu python -m tools.port_numerics
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import models
from tests import test_torch_port_resnet as T


def _worst(got, want) -> float:
    if isinstance(got, dict):
        return max(_worst(got[k], want[k]) for k in got)
    got, want = (torch.as_tensor(np.asarray(a, np.float64))
                 for a in (got, want))
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def _port_grads(which, variables, images, labels):
    model = T._port(T._port_model(which, torch.float32), variables).train()
    F.cross_entropy(model(T._nchw(images)),
                    torch.from_numpy(labels)).backward()
    return model, {n: p.grad for n, p in model.named_parameters()}


def _flax_grads(model, variables, stats, grads):
    return models.resnet_from_jax_variables(
        {"params": grads, "batch_stats": stats}, model)


def fp32_against_float64():
    for batch, px, seed in ((8, 64, 0), (2, 32, 0), (2, 32, 5)):
        images, labels = T._inputs(batch=batch, px=px, seed=seed)
        variables = T._variables("resnet18", images)
        _, _, stats64, grads64 = T._reference("resnet18", variables, images,
                                              labels)
        _, _, stats32, grads32 = T._jax_train(
            T._flax("resnet18", jnp.float32), variables, images, labels)
        errs = []
        for onednn in (True, False):
            with torch.backends.mkldnn.flags(enabled=onednn):
                model, port = _port_grads("resnet18", variables, images,
                                          labels)
            errs.append(_worst(port, _flax_grads(model, variables, stats64,
                                                 grads64)))
        xla = _flax_grads(model, variables, stats32, grads32)
        print("1. ResNet-18 batch %d %dpx seed %d, fp32 vs float64 "
              "gradients: XLA %.3e, port %.3e (oneDNN off: %.3e)"
              % (batch, px, seed, _worst(xla, _flax_grads(
                  model, variables, stats64, grads64)), errs[0], errs[1]))


def port_fp32_at_test_inputs():
    for which in ("resnet18", "bottleneck"):
        errs = []
        for seed in range(4):
            images, labels = T._inputs(seed=seed)
            variables = T._variables(which, images)
            _, _, stats, grads = T._reference(which, variables, images,
                                              labels)
            model, port = _port_grads(which, variables, images, labels)
            errs.append(_worst(port, _flax_grads(model, variables, stats,
                                                 grads)))
        print("2. %s batch 8 32px seeds 0-3: port fp32 vs float64 gradients"
              " %s" % (which, " ".join("%.2e" % e for e in errs)))


def bf16_logits():
    for which in ("resnet18", "bottleneck"):
        rows = []
        for seed in range(3):
            images, labels = T._inputs(batch=4, px=64, seed=seed)
            variables = T._variables(which, images)
            _, exact, _, _ = T._reference(which, variables, images, labels)
            _, flax, _, _ = T._jax_train(T._flax(which, jnp.bfloat16),
                                         variables, images, labels)
            model = T._port(T._port_model(which, torch.bfloat16),
                            variables).train()
            with torch.no_grad():
                port = model(T._nchw(images)).numpy()
            rows.append("port %.3f flax %.3f port-flax %.3f" % (
                _worst(port, exact), _worst(flax, exact),
                _worst(port, flax)))
        print("3. %s bf16 logits, batch 4 64px seeds 0-2: %s"
              % (which, "; ".join(rows)))


def _reduced_step(state, images, labels, dtype, sync_bn=False):
    model = models.ResNet([1, 1, 1, 1], num_filters=16, num_classes=100,
                          dtype=dtype, sync_bn=sync_bn, device="cpu")
    model.load_state_dict(state)
    model = model.to(dtype).train()
    if dtype == torch.float64:  # the dense layer runs on x.float()
        model.dense.forward = lambda x: F.linear(
            x.double(), model.dense.weight, model.dense.bias)
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    logits = model(images.to(dtype))
    F.cross_entropy(logits, labels).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    return dict(logits=logits.detach(), grads=grads,
                stats=dict(model.named_buffers()),
                params={n: p.detach() for n, p in model.named_parameters()})


def reduced_resnet_checks():
    gen = torch.Generator().manual_seed(2)
    ref = models.ResNet([1, 1, 1, 1], num_filters=16, num_classes=100,
                        dtype=torch.float32, device="cpu", generator=gen)
    images = torch.randn(4, 3, 64, 64, generator=gen)
    labels = torch.randint(0, 100, (4,), generator=gen)
    state = ref.state_dict()
    fp32 = _reduced_step(state, images, labels, torch.float32)
    fp64 = _reduced_step(state, images, labels, torch.float64)
    sync = _reduced_step(state, images, labels, torch.float32, True)
    print("4. reduced ResNet seed 2: fp32 vs float64 %s; SyncBatchNorm vs "
          "BatchNorm %s" % (
              ", ".join("%s %.2e" % (k, _worst(fp32[k], fp64[k]))
                        for k in fp64),
              ", ".join("%s %.2e" % (k, _worst(sync[k], fp32[k]))
                        for k in fp32)))


def main():
    jax.config.update("jax_platforms", "cpu")
    hvd.init(device="cpu")
    try:
        fp32_against_float64()
        port_fp32_at_test_inputs()
        bf16_logits()
        reduced_resnet_checks()
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
