"""Weight transfer from the flax models' variable trees.

Each function takes a reference model's tree as nested dicts of numpy
arrays (``Partitioned`` boxes already removed) and returns a state dict
for the port's model, after checking that the names and shapes are
exactly the ones the port's model has:

- ``from_jax_params``: the transformer (``models.transformer``), whose
  names and shapes are the flax model's, so this is a renaming;
- ``resnet_from_jax_variables``: ``models.resnet.ResNet`` from
  ``params`` plus ``batch_stats``; conv kernels go from HWIO to OIHW,
  the dense kernel from (in, out) to (out, in);
- ``mnist_from_jax_params``: ``models.mnist``, the same two transposes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from horovod_tpu_torch.models.transformer import TransformerConfig


def _expected_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    m, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff
    d = m // h
    shapes = {"embed": (cfg.vocab_size, m), "pos": (cfg.max_seq_len, m),
              "ln_f.scale": (m,), "ln_f.bias": (m,)}
    for i in range(cfg.n_layers):
        p = "layers.%d." % i
        shapes.update({
            p + "ln1.scale": (m,), p + "ln1.bias": (m,),
            p + "attn.wqkv": (3, m, h, d), p + "attn.wo": (h, d, m),
            p + "ln2.scale": (m,), p + "ln2.bias": (m,),
            p + "mlp.wi": (m, f), p + "mlp.wo": (f, m),
        })
    return shapes


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        name = prefix + str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = np.asarray(value)
    return flat


def _torch_name(flax_name: str) -> str:
    if flax_name.startswith("layer_"):
        idx, rest = flax_name[len("layer_"):].split(".", 1)
        return "layers.%s.%s" % (idx, rest)
    return flax_name


def from_jax_params(tree: Mapping, cfg: TransformerConfig
                    ) -> Dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) from the flax parameter tree.

    Accepts the tree with or without its top-level ``"params"`` key.
    """
    if "params" in tree:
        tree = tree["params"]
    flat = {_torch_name(k): v for k, v in _flatten(tree).items()}
    expected = _expected_shapes(cfg)
    if set(flat) != set(expected):
        raise ValueError(
            "parameter names differ: missing %s, unexpected %s"
            % (sorted(set(expected) - set(flat)),
               sorted(set(flat) - set(expected))))
    out = {}
    for name, shape in expected.items():
        arr = flat[name]
        if arr.shape != shape:
            raise ValueError("%s: shape %s, expected %s"
                             % (name, arr.shape, shape))
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def _transposed(arr: np.ndarray) -> np.ndarray:
    """flax kernel layout to torch's: HWIO -> OIHW, (in, out) -> (out,
    in); other ranks as they are."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:
        return arr.T
    return arr


def _checked(flat: Mapping[str, np.ndarray],
             expected: Mapping[str, tuple]) -> Dict[str, torch.Tensor]:
    if set(flat) != set(expected):
        raise ValueError(
            "parameter names differ: missing %s, unexpected %s"
            % (sorted(set(expected) - set(flat)),
               sorted(set(flat) - set(expected))))
    out = {}
    for name, shape in expected.items():
        arr = _transposed(np.asarray(flat[name]))
        if arr.shape != tuple(shape):
            raise ValueError("%s: shape %s, expected %s"
                             % (name, arr.shape, tuple(shape)))
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


_RESNET_NAMES = {"kernel": "weight", "Dense_0": "dense"}


def _resnet_name(flax_name: str) -> str:
    """``BottleneckBlock_3.BatchNorm_1.scale`` -> ``blocks.3.bn1.scale``;
    ``Dense_0.kernel`` -> ``dense.weight``."""
    parts = []
    for part in flax_name.split("."):
        m = re.fullmatch(r"\w*Block_(\d+)", part)
        if m:
            parts += ["blocks", m.group(1)]
            continue
        m = re.fullmatch(r"(Conv|BatchNorm)_(\d+)", part)
        if m:
            parts.append({"Conv": "conv", "BatchNorm": "bn"}[m.group(1)]
                         + m.group(2))
            continue
        parts.append(_RESNET_NAMES.get(part, part))
    return ".".join(parts)


def resnet_from_jax_variables(variables: Mapping, model: torch.nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) for ``model``, a port ``ResNet`` of
    the flax model's configuration, from the flax variables ``{"params":
    ..., "batch_stats": ...}``. The batch norms' running ``mean`` and
    ``var`` come from ``batch_stats``."""
    flat = {_resnet_name(k): v for k, v in _flatten(variables["params"]
                                                    ).items()}
    flat.update({_resnet_name(k): v for k, v in
                 _flatten(variables["batch_stats"]).items()})
    return _checked(flat, {k: tuple(v.shape)
                           for k, v in model.state_dict().items()})


_MNIST_SHAPES = {
    "cnn": {"conv0.weight": (10, 1, 5, 5), "conv0.bias": (10,),
            "conv1.weight": (20, 10, 5, 5), "conv1.bias": (20,),
            "dense0.weight": (50, 320), "dense0.bias": (50,),
            "dense1.weight": (10, 50), "dense1.bias": (10,)},
    "mlp": {"dense0.weight": (512, 784), "dense0.bias": (512,),
            "dense1.weight": (512, 512), "dense1.bias": (512,),
            "dense2.weight": (10, 512), "dense2.bias": (10,)},
}


def mnist_from_jax_params(tree: Mapping, which: str
                          ) -> Dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) for ``MnistCNN`` (``which="cnn"``)
    or ``MnistMLP`` (``"mlp"``) from the flax parameter tree, with or
    without its top-level ``"params"`` key. ``Dense_0``'s rows stay in
    the flax order: the port flattens NHWC features, as the flax CNN
    does."""
    if "params" in tree:
        tree = tree["params"]
    flat = {re.sub(r"(Conv|Dense)_(\d+)",
                   lambda m: m.group(1).lower() + m.group(2), k)
            .replace("kernel", "weight"): v
            for k, v in _flatten(tree).items()}
    return _checked(flat, _MNIST_SHAPES[which])
