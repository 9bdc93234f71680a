"""The Hopper backward at head dims 16-128 on the card (``@pytest.mark.cuda``;
skips without one). No JAX here: the parity with the reference runs on the
CPU in tests/test_torch_port_flash_attention.py, where the rounding of
these kernels on their ``BWD_TILES`` is emulated.

bf16 and fp16 dK/dV run ``dkv_rows_wgmma_kernel`` and dQ
``dq_rows_wgmma_kernel`` (``csrc/hopper_bwd.cuh``): wgmma, TMA and a
producer warpgroup. Each is held to its plain version within chip_smoke.py's
limits (``compare_kernels``: on the plain forward's lse and delta, and
chained on the kernel forward's) at every head dim of ``BWD_TILES``, on
ragged shapes (Sq < Skv, and Sq > Skv where the first rows see no key
under the causal mask), causal and not; two runs must be bit-equal. Which
kernels run is read by chip_smoke.py (``TENSOR_CORE_KERNELS``, under
torch.profiler in a process of its own: a second profiling session after
many unprofiled launches in one process can see no events, which fails
tests/test_torch_port_flash_wide_cards.py's route test), and its SASS check
finds every instantiation. Run with ``python3 -m pytest
tests/test_torch_port_flash_bwd_cards.py -m cuda -q`` on a machine with a
card.
"""

import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa

BWD_DIMS = sorted(fa.BWD_TILES)
DTYPES = (torch.bfloat16, torch.float16)
# (B, H, Sq, Skv): ragged tiles both ways; with Sq > Skv the first 70 query
# rows see no key under the causal mask.
RAGGED = ((2, 3, 130, 300), (2, 2, 200, 130))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("d", BWD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", RAGGED)
def test_backward_kernels_match_plain_versions(card, d, dtype, causal,
                                               shape):
    errs = chip_smoke.compare_kernels(torch, fa, *shape, d, dtype, causal,
                                      "cuda")
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        parts, _ = errs[name]
        assert all(r <= 1.0 for _, r in parts), (name, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("d", BWD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_kernels_are_bit_equal_over_two_runs(card, d, dtype):
    """Each dK/dV and dQ element is written by one block in a fixed order,
    with no atomics."""
    g = torch.Generator(device="cuda").manual_seed(d + 7)
    q, k, v, do = (torch.randn(2, 4, 300, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, d ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, d ** -0.5)
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args))

