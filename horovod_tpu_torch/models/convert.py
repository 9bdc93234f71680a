"""Weight transfer from the flax transformer's parameter tree.

``from_jax_params`` takes the reference model's parameter tree as nested
dicts of numpy arrays (``Partitioned`` boxes already removed) and returns
a state dict for ``models.transformer.Transformer``. The two models keep
the same names and shapes, so this is a renaming plus a shape check.
"""

from __future__ import annotations

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
