"""Flash attention on the card at every head dim (``@pytest.mark.cuda``;
skips without one). No JAX here: the parity with the reference runs on the
CPU in tests/test_torch_port_flash_attention.py.

Head dims above 128 run on the wide family (``csrc/flash_attention_wide.cu``)
in fp32, bf16 and fp16; the bf16/fp16 forward is a Hopper kernel up to
head dim 576 (``fwd_wgmma_kernel`` up to 256, ``wide_fwd_wgmma_kernel`` at
320-576) and the sliced ``wide_fwd_kernel`` above, whose lse feeds the
backward kernels. Each kernel is held to its plain version within
chip_smoke.py's limits (``compare_kernels``: the backward on the plain
forward's lse and delta, and chained on the kernel forward's). Run with
``python3 -m pytest tests/test_torch_port_flash_wide_cards.py -m cuda -q``
on a machine with a card.
"""

import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa

WIDE = (192, 256, 512, 576, 640)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _held(errs):
    for name, (parts, _) in errs.items():
        assert all(r <= 1.0 for _, r in parts), (name, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_head_dim_launches_each_kernel_once(card, d, dtype):
    """``flash_attention`` at D > 128 through autograd: one launch of each
    kernel, and O within chip_smoke.py's limits of the CPU's plain
    version."""
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(1, 200, 2, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launches()
    out = fa.flash_attention(*ts, causal=True)
    out.backward(do)
    assert [f.launches for f in fa.KERNELS] == [1, 1, 1]
    assert all(t.grad.shape == t.shape and t.grad.dtype == dtype
               for t in ts)
    want = fa.flash_attention(*(x.cpu() for x in (q, k, v)), causal=True)
    rtol, atol = chip_smoke.TOLS[str(dtype)[6:]]
    assert chip_smoke.limit_ratio(out.detach().transpose(1, 2).cpu(),
                                  want.transpose(1, 2), rtol, atol) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE + (160,))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_wide_kernels_match_plain_versions(card, d, dtype, causal):
    """Ragged tiles, Sq != Skv; D = 160 runs padded to 192."""
    _held(chip_smoke.compare_kernels(torch, fa, 2, 2, 130, 200, d, dtype,
                                     causal, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("causal", [True, False])
def test_hopper_forward_and_its_lse_in_the_backward(card, d, dtype, causal):
    """The Hopper forward against its plain version, and its lse (with
    delta from its O) feeding the backward kernels within their limits."""
    _held(chip_smoke.compare_kernels(torch, fa, 2, 3, 130, 300, d, dtype,
                                     causal, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_hopper_forward_at_the_slice_shape(card, dtype):
    b, h, s, d = chip_smoke.SLICE_SHAPE
    _held(chip_smoke.compare_kernels(torch, fa, b, h, s, s, d, dtype, True,
                                     "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_backward_is_bit_equal_over_two_runs(card, dtype):
    """Each dK/dV and dQ element is summed by one block in a fixed order."""
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(2, 4, 256, 256, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, 256 ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, 256 ** -0.5)
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", (192, 256, 512, 576))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("causal", [True, False])
def test_wide_hopper_forward_and_its_lse_in_the_backward(card, d, dtype,
                                                         causal):
    """The wide Hopper forward against its plain version, and its lse (with
    delta from its O) feeding the backward kernels within their limits;
    ragged tiles, Sq < Skv."""
    _held(chip_smoke.compare_kernels(torch, fa, 2, 3, 130, 300, d, dtype,
                                     causal, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("d", (192, 256, 512, 576))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_wide_hopper_forward_is_bit_equal_over_two_runs(card, d, dtype):
    """Each O and lse element is written by one block in a fixed order."""
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(2, 4, 300, d, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    first = fa.flash_fwd(q, k, v, True, d ** -0.5)
    second = fa.flash_fwd(q, k, v, True, d ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("causal", [True, False])
def test_16bit_forward_past_the_hopper_head_dims(card, dtype, causal):
    """At D = 640, past ``WIDE_FWD_TILES``, the bf16/fp16 forward runs the
    sliced kernel: within its limits of the plain version, its lse in the
    backward within theirs (ragged tiles, Sq < Skv), and O and lse
    bit-equal over two runs."""
    d = 640
    assert d not in fa.WIDE_FWD_TILES and fa.padded_head_dim(d) == d
    _held(chip_smoke.compare_kernels(torch, fa, 2, 3, 130, 300, d, dtype,
                                     causal, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(2, 4, 300, d, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    first = fa.flash_fwd(q, k, v, causal, d ** -0.5)
    second = fa.flash_fwd(q, k, v, causal, d ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
