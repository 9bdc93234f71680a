"""The port's flash tile tuner on the card (``@pytest.mark.cuda``; skips
without one). No JAX here: the parity with the reference runs on the CPU
in tests/test_torch_port_block_tuner.py.

On the card the candidates are the tiles the kernels compile (one), the
tuner times the real fwd+bwd step and journals the card's key, and a
resolved tile that no kernel compiles raises before anything launches.
Run with ``python3 -m pytest tests/test_torch_port_block_tuner_cards.py -m
cuda -q`` on a machine with a card.
"""

import json

import pytest
import torch

from horovod_tpu_torch.ops import block_tuner
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.utils import metrics

KNOBS = ("HVD_FLASH_TUNE", "HVD_FLASH_TUNE_CACHE", "HVD_FLASH_TUNE_SYNC",
         "HVD_FLASH_TUNE_CANDIDATES", "HVD_FLASH_TUNE_ITERS",
         "HVD_FLASH_BLOCK_Q", "HVD_FLASH_BLOCK_K")


@pytest.fixture
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", str(tmp_path / "c.jsonl"))
    block_tuner._mem_cache, block_tuner._mem_cache_path = {}, None
    yield str(tmp_path / "c.jsonl")
    block_tuner._mem_cache, block_tuner._mem_cache_path = {}, None


@pytest.mark.cuda
def test_candidates_clamp_to_the_compiled_tiles_on_card(card):
    assert fa.COMPILED_TILES == (fa.TILE,)
    for seq, cands in ((64, (128, 256, 512)), (2048, (32, 64, 1024)),
                       (100, None)):
        assert block_tuner.candidate_pairs(seq, seq, cands,
                                           device="cuda") == [(64, 64)]


@pytest.mark.cuda
def test_tune_on_card_writes_the_cards_key(card):
    """One candidate timed with CUDA events on the real step; the record
    names the card; ``flash_attention`` then reads it without a trial."""
    before = metrics.value("hvd_flash_tuner_trials_total") or 0
    won = block_tuner.tune(1024, 1024, 80, torch.float16, True, iters=2,
                           batch=1, heads=4, device="cuda")
    assert won == (fa.TILE, fa.TILE)
    assert metrics.value("hvd_flash_tuner_trials_total") - before == 1
    with open(card) as fh:
        (rec,) = [json.loads(line) for line in fh]
    name = torch.cuda.get_device_name(0).replace(" ", "_")
    assert rec["key"] == "q1024.kv1024.d80.float16.causal.gpu-" + name
    assert rec["ms_per_step"] > 0 and rec["trials"] == 1
    trials = metrics.value("hvd_flash_tuner_trials_total")
    q = torch.randn(1, 1024, 4, 80, device="cuda", dtype=torch.float16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVD_FLASH_TUNE", "1")
        fa.flash_attention(q, q, q, causal=True)
    assert metrics.value("hvd_flash_tuner_trials_total") == trials


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["argument", "variable", "cache"])
def test_a_resolved_128_raises_on_card(card, monkeypatch, how):
    q = torch.randn(1, 256, 2, 64, device="cuda", dtype=torch.bfloat16)
    kw = {}
    if how == "argument":
        kw["block_q"] = 128
    elif how == "variable":
        monkeypatch.setenv("HVD_FLASH_BLOCK_Q", "128")
    else:
        key = block_tuner.shape_key(256, 256, 64, torch.bfloat16, True,
                                    block_tuner._device_kind("cuda"))
        block_tuner.append_record({"version": block_tuner.CACHE_VERSION,
                                   "key": key, "block_q": 128,
                                   "block_k": 64})
        monkeypatch.setenv("HVD_FLASH_TUNE", "cache")
    fa.reset_launches()
    with pytest.raises(ValueError, match="block_q=128"):
        fa.flash_attention(q, q, q, causal=True, **kw)
    assert [f.launches for f in fa.KERNELS] == [0, 0, 0]
