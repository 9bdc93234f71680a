"""The cell's weights, made by the benchmark from the seed on the device,
in a few large calls: one normal draw for every random leaf, cut into
views and scaled leaf by leaf. The program loads them by name; the plain
reference draws the same again. Names and shapes are the program's
``state_dict`` keys, written out here from the configuration."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.yardstick import mix

# (name, shape, init): init is ("normal", std), ("trunc", std) (a normal
# clamped at two standard deviations), ("ones",) or ("zeros",).
Leaf = Tuple[str, Tuple[int, ...], tuple]


def transformer_leaves(config: dict) -> List[Leaf]:
    m, h, f = config["n_embd"], config["n_head"], config["n_inner"]
    d, std = m // h, config["initializer_range"]
    leaves = [("embed", (config["vocab_size"], m), ("normal", std)),
              ("pos", (config["n_positions"], m), ("normal", std))]
    for i in range(config["n_layer"]):
        p = "layers.%d." % i
        leaves += [
            (p + "ln1.scale", (m,), ("ones",)),
            (p + "ln1.bias", (m,), ("zeros",)),
            (p + "attn.wqkv", (3, m, h, d), ("normal", std)),
            (p + "attn.wo", (h, d, m), ("normal", std)),
            (p + "ln2.scale", (m,), ("ones",)),
            (p + "ln2.bias", (m,), ("zeros",)),
            (p + "mlp.wi", (m, f), ("normal", std)),
            (p + "mlp.wo", (f, m), ("normal", std)),
        ]
    return leaves + [("ln_f.scale", (m,), ("ones",)),
                     ("ln_f.bias", (m,), ("zeros",))]


def _bn(name: str, n: int, scale: tuple = ("ones",)) -> List[Leaf]:
    return [(name + ".scale", (n,), scale),
            (name + ".bias", (n,), ("zeros",)),
            (name + ".mean", (n,), ("zeros",)),
            (name + ".var", (n,), ("ones",))]


def _conv(name: str, cin: int, cout: int, k: int) -> Leaf:
    # lecun normal: variance 1 / fan_in.
    return (name + ".weight", (cout, cin, k, k),
            ("trunc", (1.0 / (cin * k * k)) ** 0.5))


def resnet_leaves(config: dict) -> List[Leaf]:
    """v1.5's leaves. Each block's last batch norm starts at scale 0, so
    that each block starts as the identity (as the port's ``ResNet``
    does): at scale 1 the first step's gradient of a deep stack turns its
    direction under any rounding, bf16's as much as fp8's."""
    filters = config["num_filters"]
    leaves = [_conv("conv_init", 3, filters, 7)] + _bn("bn_init", filters)
    cin, b = filters, 0
    for i, count in enumerate(config["stage_sizes"]):
        feat = filters * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            p = "blocks.%d." % b
            for k, (c_in, c_out, size) in enumerate(
                    ((cin, feat, 1), (feat, feat, 3), (feat, 4 * feat, 1))):
                leaves += [_conv(p + "conv%d" % k, c_in, c_out, size)] \
                    + _bn(p + "bn%d" % k, c_out,
                          ("zeros",) if k == 2 else ("ones",))
            if stride != 1 or cin != 4 * feat:
                leaves += [_conv(p + "conv_proj", cin, 4 * feat, 1)] \
                    + _bn(p + "norm_proj", 4 * feat)
            cin, b = 4 * feat, b + 1
    classes = config["num_classes"]
    return leaves + [("dense.weight", (classes, cin),
                      ("trunc", (1.0 / cin) ** 0.5)),
                     ("dense.bias", (classes,), ("zeros",))]


LEAVES = {"transformer": transformer_leaves, "resnet": resnet_leaves}


def leaves(config: dict) -> List[Leaf]:
    return LEAVES[config["family"]](config)


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf as an fp32 tensor on ``device``. The random leaves are
    views of one buffer drawn in one call from a generator on the device
    seeded from ``seed``; the same seed gives the same weights."""
    spec = leaves(config)
    random = [(n, s, i) for n, s, i in spec if i[0] in ("normal", "trunc")]
    total = sum(_numel(s) for _, s, _ in random)
    gen = torch.Generator(device=device).manual_seed(mix(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init in spec:
        if init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        if init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = _numel(shape)
        w = flat[off:off + n].view(shape)
        off += n
        if init[0] == "trunc":
            w.clamp_(-2.0, 2.0)
        out[name] = w.mul_(init[1])
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
