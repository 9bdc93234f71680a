"""The benchmark's frozen arithmetic against the program's own and against
counts made by hand on the layer shapes."""

import pytest

import portbench_tiny as tiny  # noqa: F401  (puts the checkout on the path)
from portbench import spec, weights, yardstick


@pytest.mark.parametrize("shape", [
    (4, 8, 2048, 2048, 64, "bf16", True),      # the kernel table's slice
    (16, 16, 2048, 2048, 128, "bf16", True),   # the LM cell's attention
    (2, 3, 100, 130, 64, "fp16", True),
    (2, 3, 100, 130, 32, "fp32", False),
])
def test_bounds_copy_matches_chip_smoke(shape):
    import chip_smoke

    assert yardstick.bounds(*shape) == chip_smoke.bounds(*shape)
    assert yardstick.PEAK_FLOPS == chip_smoke.PEAK_FLOPS
    assert yardstick.PEAK_BYTES == chip_smoke.PEAK_BYTES


def test_lm_cell_attention_shape():
    cell = tiny.load_cell(tiny.LM)
    assert yardstick.attention_shape(cell.config, cell.traffic) == \
        (16, 16, 2048, 128)


def _hand_matmul_params(config):
    """Every weight leaf that multiplies activations, read off the shapes
    of the leaves (``weights``' names are the program's): q, k, v, output
    and MLP matrices, and the embedding as the tied output head."""
    n = 0
    for name, shape, _ in weights.leaves(config):
        if name == "embed" or name.endswith(("attn.wqkv", "attn.wo",
                                             "mlp.wi", "mlp.wo")):
            count = 1
            for s in shape:
                count *= s
            n += count
    return n


def test_lm_flops_by_hand():
    config = tiny.load_cell(tiny.LM).config
    assert yardstick.lm_matmul_params(config) == \
        _hand_matmul_params(config) == 1_310_885_888
    total = sum(_numel(s) for _, s, _ in weights.leaves(config))
    assert total == config["parameters"] == 1_315_280_896
    s = 2048
    # causal pairs of one sequence, QKᵀ and PV, 2 FLOPs a product,
    # forward and backward (3x), per token
    attn = 3 * 2 * 2 * (s * (s + 1) // 2) * 2048 * 24 / s
    want = 6 * 1_310_885_888 + attn
    assert yardstick.lm_flops_per_token(config, s) == pytest.approx(want)
    assert yardstick.lm_flops_per_token(config, s) == pytest.approx(
        8.47e9, rel=1e-3)


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def test_resnet_flops_match_the_layer_shapes():
    """The counted forward FLOPs against chip_smoke's hook count on the
    port's ResNet-50 at 224 px (a forward of one image on the CPU)."""
    import torch

    import chip_smoke
    from horovod_tpu_torch import models

    config = spec.load_cell(tiny.RN).config
    model = models.ResNet50(num_classes=1000, dtype=torch.float32,
                            device="cpu")
    counted = chip_smoke.resnet_fwd_flops(torch, model, 224, "cpu")
    assert yardstick.resnet_fwd_flops(config, 224) == counted
    assert counted == pytest.approx(8.178e9, rel=1e-3)
    total = sum(_numel(s) for n, s, _ in weights.leaves(config)
                if not n.endswith((".mean", ".var")))
    assert total == config["parameters"] == sum(
        p.numel() for p in model.parameters())


@pytest.mark.parametrize("workload", [tiny.LM, tiny.RN])
def test_weight_leaves_are_the_programs(workload):
    """The benchmark's leaves have the program's names and shapes."""
    import torch

    from horovod_tpu_torch import models
    from portbench import script

    cell = tiny.load_cell(workload)
    config, traffic = cell.config, cell.traffic
    model = script.build_model(models, config, traffic,
                               torch.device("meta"))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in weights.leaves(config)} == want


def test_weights_repeat_by_seed():
    config = dict(tiny.TINY_CONFIG["transformer"], family="transformer",
                  initializer_range=0.02)
    a = weights.make(config, 7, "cpu")
    b = weights.make(config, 7, "cpu")
    c = weights.make(config, 8, "cpu")
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["embed"] == c["embed"]).all()
