"""The general traffic generator of a training cell: a pool of batches per
rank, drawn on the device from the seed, the rank and the batch's index.
Batch ``j`` of rank ``r`` is the same whoever asks for it, so the plain
reference draws the batches that the program trained on again. What a
mix looks like (sizes, id distribution, pool) is its traffic file."""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.yardstick import mix


def _generator(seed: int, rank: int, index: int, device):
    return torch.Generator(device=device).manual_seed(
        mix(seed, "batch", rank, index))


def token_batch(traffic: dict, config: dict, seed: int, rank: int,
                index: int, device) -> torch.Tensor:
    """(batch, seq_len) int64 token ids, id k drawn with weight
    1 / (k + 1) ** ``zipf_s`` over the whole vocabulary, as the words of a
    text fall."""
    vocab = config["vocab_size"]
    shape = (traffic["batch"], traffic["seq_len"])
    gen = _generator(seed, rank, index, device)
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    weights = ranks.pow(-float(traffic["zipf_s"]))
    ids = torch.multinomial(weights, shape[0] * shape[1], replacement=True,
                            generator=gen)
    return ids.view(shape)


def image_batch(traffic: dict, config: dict, seed: int, rank: int,
                index: int, device,
                dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic images N(0, 1) in ``dtype``, channels_last, and uniform
    labels, as Horovod's ``pytorch_synthetic_benchmark.py`` makes them."""
    px, n = traffic["px"], traffic["batch"]
    gen = _generator(seed, rank, index, device)
    images = torch.randn(n, 3, px, px, generator=gen, device=device).to(
        dtype).contiguous(memory_format=torch.channels_last)
    labels = torch.randint(0, config["num_classes"], (n,), generator=gen,
                           device=device)
    return images, labels


def batch(traffic: dict, config: dict, seed: int, rank: int, index: int,
          device):
    """Batch ``index`` of ``rank``: (inputs, targets)."""
    if config["family"] == "transformer":
        tokens = token_batch(traffic, config, seed, rank, index, device)
        return tokens, torch.roll(tokens, -1, dims=1)
    return image_batch(traffic, config, seed, rank, index, device)
