"""The port's flash tile tuner (``horovod_tpu_torch/ops/block_tuner.py``)
against the reference's (``horovod_tpu/ops/block_tuner.py``).

Each case of tests/test_block_tuner.py runs on both packages in this
process, with the same injected ``time_fn`` and the knobs' variables
scrubbed between the two: the journals must be the same bytes (apart
from ``ms_per_step`` where the timer is real), the winners and the
precedence of argument, ``HVD_FLASH_BLOCK_Q/K``, cache and default the
same, and each package reads a cache that the other wrote. On the CPU the
key's device is ``cpu-cpu`` in both (JAX's platform and kind of its CPU
device). Meta tensors stand in for a card where the port clamps its
candidates to the compiled tile. The np 2 runs (the port's twin of
``test_np2_divergent_caches_adopt_rank0_winner``) go through
tests/torch_port_flash_sync_worker.py on gloo.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.ops import block_tuner as ref
from horovod_tpu.ops import pallas_attention
from horovod_tpu.utils import metrics as ref_metrics
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import block_tuner as port
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.utils import metrics as port_metrics
from torch_port_runs import start_runs

HERE = os.path.dirname(os.path.abspath(__file__))
KNOBS = ("HVD_FLASH_TUNE", "HVD_FLASH_TUNE_CACHE", "HVD_FLASH_TUNE_SYNC",
         "HVD_FLASH_TUNE_CANDIDATES", "HVD_FLASH_TUNE_ITERS",
         "HVD_FLASH_BLOCK_Q", "HVD_FLASH_BLOCK_K")
PACKAGES = (("ref", ref), ("port", port))


def _fresh(mod):
    mod._mem_cache = {}
    mod._mem_cache_path = None


@pytest.fixture(autouse=True)
def _scrubbed(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    for _, mod in PACKAGES:
        _fresh(mod)
    yield
    for _, mod in PACKAGES:
        _fresh(mod)


def _both(tmp_path, monkeypatch, scenario):
    """Run ``scenario(mod, path)`` on each package with a cache file of
    its own under a scrubbed environment; returns {package: (result,
    the cache file's bytes or None)}."""
    out = {}
    for name, mod in PACKAGES:
        for knob in KNOBS:
            monkeypatch.delenv(knob, raising=False)
        path = str(tmp_path / ("%s.jsonl" % name))
        monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", path)
        _fresh(mod)
        result = scenario(mod, path)
        data = open(path, "rb").read() if os.path.exists(path) else None
        out[name] = (result, data)
    return out


def _same(tmp_path, monkeypatch, scenario):
    out = _both(tmp_path, monkeypatch, scenario)
    assert out["port"] == out["ref"]
    return out["port"]


def _rec(mod, key, bq, bk, **extra):
    rec = {"version": mod.CACHE_VERSION, "key": key, "block_q": bq,
           "block_k": bk}
    rec.update(extra)
    return rec


def _kind(mod):
    return mod._device_kind("cpu") if mod is port else mod._device_kind()


# ------------------------------------------------------------- journal ---

class TestCacheJournal:
    def test_round_trip(self, tmp_path, monkeypatch):
        def scenario(mod, path):
            mod.append_record(_rec(mod, "k1", 128, 256))
            mod.append_record(_rec(mod, "k2", 64, 64))
            return mod.load_cache(path)

        cache, _ = _same(tmp_path, monkeypatch, scenario)
        assert cache["k1"]["block_q"] == 128
        assert cache["k2"] == _rec(port, "k2", 64, 64)
        # Each package reads the other's file.
        for reader, writer in (("ref", "port"), ("port", "ref")):
            path = str(tmp_path / ("%s.jsonl" % writer))
            assert dict(PACKAGES)[reader].load_cache(path) == cache

    def test_last_record_wins(self, tmp_path, monkeypatch):
        def scenario(mod, path):
            mod.append_record(_rec(mod, "k", 128, 128))
            mod.append_record(_rec(mod, "k", 512, 256))
            return mod.load_cache(path)["k"]["block_q"]

        assert _same(tmp_path, monkeypatch, scenario)[0] == 512

    def test_torn_tail_tolerated(self, tmp_path, monkeypatch):
        def scenario(mod, path):
            mod.append_record(_rec(mod, "good", 64, 64))
            with open(path, "a") as fh:
                fh.write('{"version": 1, "key": "torn", "blo')
            before = sorted(mod.load_cache(path))
            mod.append_record(_rec(mod, "after", 32, 32))
            return before, sorted(mod.load_cache(path))

        (before, after), _ = _same(tmp_path, monkeypatch, scenario)
        assert before == ["good"] and after == ["after", "good"]

    def test_garbage_and_wrong_version_skipped(self, tmp_path, monkeypatch):
        def scenario(mod, path):
            with open(path, "w") as fh:
                fh.write("not json at all\n")
                fh.write(json.dumps({"version": 999, "key": "v",
                                     "block_q": 1, "block_k": 1}) + "\n")
                fh.write(json.dumps({"key": "missing-fields"}) + "\n")
            return mod.load_cache(path)

        assert _same(tmp_path, monkeypatch, scenario)[0] == {}

    def test_missing_file_is_empty_cache(self, tmp_path):
        for _, mod in PACKAGES:
            assert mod.load_cache(str(tmp_path / "nope.jsonl")) == {}

    def test_interleaved_appends_from_two_writers(self, tmp_path,
                                                  monkeypatch):
        """The two packages append to one file in turns, as two tuning
        processes would: every record survives, for either reader."""
        path = str(tmp_path / "shared.jsonl")
        monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", path)
        for i in range(10):
            ref.append_record(_rec(ref, "w1.%d" % i, 64, 64))
            port.append_record(_rec(port, "w2.%d" % i, 128, 128))
        assert len(ref.load_cache(path)) == len(port.load_cache(path)) == 20
        assert ref.load_cache(path) == port.load_cache(path)


# --------------------------------------------------- keys and candidates ---

class TestShapeKey:
    def test_key_fields(self):
        for _, mod in PACKAGES:
            assert mod.shape_key(2048, 2048, 64, "bfloat16", True,
                                 "tpu v5e") == \
                "q2048.kv2048.d64.bfloat16.causal.tpu_v5e"
            assert mod.shape_key(64, 128, 8, "float32", False, "cpu") \
                == "q64.kv128.d8.float32.full.cpu"

    @pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                         (torch.float16, jnp.float16),
                                         (torch.float32, jnp.float32)])
    def test_key_names_the_dtype_as_the_reference(self, tdt, jdt):
        """A torch dtype gives the key a JAX array's dtype gives, on the
        CPU device of each."""
        got = port.shape_key(2048, 2048, 80, tdt, True,
                             port._device_kind("cpu"))
        want = ref.shape_key(2048, 2048, 80, jnp.zeros(1, jdt).dtype, True,
                             ref._device_kind())
        assert got == want
        assert got.endswith(".causal.cpu-cpu")

    def test_candidate_pairs_clamped_and_deduped(self):
        pairs = port.candidate_pairs(64, 64, (128, 256, 512), device="cpu")
        assert pairs == ref.candidate_pairs(64, 64, (128, 256, 512)) \
            == [(64, 64)]
        assert port.candidate_pairs(200, 100, (64, 256), device="cpu") == \
            ref.candidate_pairs(200, 100, (64, 256)) == \
            [(64, 64), (64, 100), (200, 64), (200, 100)]

    def test_candidates_clamped_to_the_compiled_tile_on_a_card(self):
        """Off the CPU each candidate becomes a tile the kernels compile:
        one tile, one candidate, whatever the sequence."""
        for seq, cands in ((64, (128, 256, 512)), (200, (64, 256)),
                           (4096, (32, 128, 1024))):
            assert port.candidate_pairs(seq, seq, cands, device="meta") \
                == [(fa.TILE, fa.TILE)]

    def test_candidates_env(self, monkeypatch):
        monkeypatch.setenv("HVD_FLASH_TUNE_CANDIDATES", "16,32")
        want = [(16, 16), (16, 32), (32, 16), (32, 32)]
        assert ref.candidate_pairs(1024, 1024) == want
        assert port.candidate_pairs(1024, 1024, device="cpu") == want
        assert port.candidate_pairs(1024, 1024, device="meta") == \
            [(fa.TILE, fa.TILE)]


# ---------------------------------------------------------------- tune ---

def _tune(mod, *args, **kw):
    if mod is port:
        kw["device"] = "cpu"
    return mod.tune(*args, **kw)


class TestTune:
    def test_injected_timer_picks_fastest_and_journals(self, tmp_path,
                                                       monkeypatch):
        times = {(32, 32): 3.0, (32, 64): 1.0, (64, 32): 2.0,
                 (64, 64): 4.0}

        def scenario(mod, path):
            won = _tune(mod, 64, 64, 8, "float32", True,
                        candidates=(32, 64),
                        time_fn=lambda q, k: times[(q, k)])
            return won, mod.load_cache(path)

        (won, cache), data = _same(tmp_path, monkeypatch, scenario)
        assert won == (32, 64)
        (rec,) = cache.values()
        assert (rec["block_q"], rec["block_k"], rec["trials"]) == (32, 64, 4)
        assert rec["key"] == "q64.kv64.d8.float32.causal.cpu-cpu"
        assert data.count(b"\n") == 1

    def test_failing_candidates_are_skipped(self, tmp_path, monkeypatch):
        def time_fn(q, k):
            if (q, k) != (32, 32):
                raise RuntimeError("VMEM overflow")
            return 1.0

        def scenario(mod, path):
            return _tune(mod, 64, 64, 8, "float32", True,
                         candidates=(32, 64), time_fn=time_fn)

        assert _same(tmp_path, monkeypatch, scenario)[0] == (32, 32)

    def test_all_candidates_failing_raises(self, tmp_path, monkeypatch):
        def time_fn(q, k):
            raise RuntimeError("no")

        for _, mod in PACKAGES:
            monkeypatch.setenv("HVD_FLASH_TUNE_CACHE",
                               str(tmp_path / "c.jsonl"))
            with pytest.raises(RuntimeError, match="every candidate"):
                _tune(mod, 64, 64, 8, "float32", True, candidates=(32,),
                      time_fn=time_fn)
        assert not os.path.exists(str(tmp_path / "c.jsonl"))

    def test_trials_counter(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", str(tmp_path / "c.jsonl"))
        for mod, metrics in ((ref, ref_metrics), (port, port_metrics)):
            before = metrics.value("hvd_flash_tuner_trials_total") or 0
            _tune(mod, 64, 64, 8, "float32", True, candidates=(32, 64),
                  time_fn=lambda q, k: 1.0)
            after = metrics.value("hvd_flash_tuner_trials_total")
            assert after - before == 4

    def test_real_timer_on_the_cpu(self, tmp_path, monkeypatch):
        """The default timer (fwd+bwd of each package's flash_attention):
        the same record but for ``ms_per_step``, at the CPU's one
        candidate for a 64-long sequence."""
        monkeypatch.setenv("HVD_FLASH_TUNE_ITERS", "1")

        def scenario(mod, path):
            return _tune(mod, 64, 64, 8, "float32", True)

        out = _both(tmp_path, monkeypatch, scenario)
        assert out["port"][0] == out["ref"][0] == (64, 64)
        recs = [json.loads(out[name][1]) for name in ("ref", "port")]
        for rec in recs:
            assert rec.pop("ms_per_step") > 0
        assert recs[0] == recs[1]


# --------------------------------------------------------- best_blocks ---

def _best(mod, *args):
    if mod is port:
        return mod.best_blocks(*args, device="cpu")
    return mod.best_blocks(*args)


class TestBestBlocks:
    def test_off_by_default(self):
        for _, mod in PACKAGES:
            assert _best(mod, 64, 64, 8, "float32", True) is None

    def test_cache_mode_never_measures(self, tmp_path, monkeypatch):
        def scenario(mod, path):
            os.environ["HVD_FLASH_TUNE"] = "cache"
            miss = _best(mod, 64, 64, 8, "float32", True)
            key = mod.shape_key(64, 64, 8, "float32", True, _kind(mod))
            mod.append_record(_rec(mod, key, 32, 16))
            mod._mem_cache_path = None  # force re-fold
            return miss, _best(mod, 64, 64, 8, "float32", True)

        (miss, hit), _ = _same(tmp_path, monkeypatch, scenario)
        assert miss is None and hit == (32, 16)

    @pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                               ("port", "ref")])
    def test_each_package_reads_the_others_winner(self, tmp_path,
                                                  monkeypatch, writer,
                                                  reader):
        path = str(tmp_path / "shared.jsonl")
        monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", path)
        times = {(32, 32): 2.0, (32, 64): 3.0, (64, 32): 1.0,
                 (64, 64): 4.0}
        w, r = dict(PACKAGES)[writer], dict(PACKAGES)[reader]
        assert _tune(w, 64, 64, 8, "float32", True, candidates=(32, 64),
                     time_fn=lambda q, k: times[(q, k)]) == (64, 32)
        monkeypatch.setenv("HVD_FLASH_TUNE", "cache")
        assert _best(r, 64, 64, 8, "float32", True) == (64, 32)


# ------------------------------------------------------------ precedence ---

def _ref_blocks(monkeypatch, block_q, block_k, seq=1024, d=8):
    """The reference's resolved tiles, caught at its kernel's entry (its
    ``_pick_block`` keeps every tile here: each divides the sequence)."""
    picked = {}

    def spy(qt, kt, vt, causal, bq, bk, scale, interpret):
        picked["blocks"] = (bq, bk)
        return jnp.zeros_like(qt)

    monkeypatch.setattr(pallas_attention, "_flash", spy)
    q = jnp.zeros((1, seq, 1, d), jnp.float32)
    pallas_attention.flash_attention(q, q, q, causal=True, block_q=block_q,
                                     block_k=block_k)
    return picked["blocks"]


@pytest.mark.parametrize("env,cache,arg,want", [
    ({}, None, (None, None), (256, 512)),
    ({}, None, (128, None), (128, 512)),
    ({}, None, (None, 256), (256, 256)),
    ({"HVD_FLASH_BLOCK_Q": "128"}, None, (None, None), (128, 512)),
    ({"HVD_FLASH_BLOCK_K": "128"}, None, (512, None), (512, 128)),
    ({"HVD_FLASH_TUNE": "cache"}, (128, 256), (None, None), (128, 256)),
    ({"HVD_FLASH_TUNE": "cache"}, None, (None, None), (256, 512)),
    ({"HVD_FLASH_TUNE": "cache"}, (128, 256), (512, None), (512, 512)),
    ({"HVD_FLASH_TUNE": "cache", "HVD_FLASH_BLOCK_K": "128"}, (128, 256),
     (None, None), (256, 128)),
    ({"HVD_FLASH_TUNE": "cache", "HVD_FLASH_BLOCK_Q": "512"}, (128, 256),
     (None, 128), (512, 128)),
])
def test_precedence_equals_the_reference(tmp_path, monkeypatch, env, cache,
                                         arg, want):
    """Argument > HVD_FLASH_BLOCK_Q/K > cache > default, the tuner read
    only when neither argument nor either variable is set."""
    path = str(tmp_path / "c.jsonl")
    got = {}
    for name, mod in PACKAGES:
        for knob in KNOBS:
            monkeypatch.delenv(knob, raising=False)
        monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", path)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        _fresh(mod)
        if cache is not None:
            key = mod.shape_key(1024, 1024, 8, "float32", True, _kind(mod))
            mod.append_record(_rec(mod, key, *cache), path)
        if name == "ref":
            got[name] = _ref_blocks(monkeypatch, *arg)
        else:
            got[name] = fa.resolve_blocks(1024, 1024, 8, torch.float32, True,
                                          "cpu", *arg)
        if os.path.exists(path):
            os.remove(path)
    assert got["port"] == got["ref"] == want


def test_resolved_tile_off_the_compiled_one_raises_on_a_card(tmp_path,
                                                             monkeypatch):
    """On a card (meta stands in) a resolved tile other than the compiled
    one raises, from the argument, the variable or the cache alike; the
    default is the compiled tile."""
    monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", str(tmp_path / "c.jsonl"))
    assert fa.resolve_blocks(2048, 2048, 64, torch.bfloat16, True,
                             "meta") == (fa.TILE, fa.TILE)
    with pytest.raises(ValueError, match="block_q=128"):
        fa.resolve_blocks(2048, 2048, 64, torch.bfloat16, True, "meta",
                          128, None)
    monkeypatch.setenv("HVD_FLASH_BLOCK_K", "256")
    with pytest.raises(ValueError, match="block_k=256"):
        fa.resolve_blocks(2048, 2048, 64, torch.bfloat16, True, "meta")


def test_flash_attention_tunes_on_the_cpu(tmp_path, monkeypatch):
    """``HVD_FLASH_TUNE=1``: the port's ``flash_attention`` tunes its
    shape on the first call (one trial: 128/256/512 clamp to the sequence
    of 64) and reads the cache on the second (the counter stays)."""
    path = str(tmp_path / "c.jsonl")
    monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", path)
    monkeypatch.setenv("HVD_FLASH_TUNE", "1")
    monkeypatch.setenv("HVD_FLASH_TUNE_ITERS", "1")
    q = torch.tensor(np.random.RandomState(0).randn(1, 64, 1, 8),
                     dtype=torch.float32)
    before = port_metrics.value("hvd_flash_tuner_trials_total") or 0
    assert fa.flash_attention(q, q, q, causal=True).shape == q.shape
    (rec,) = port.load_cache(path).values()
    assert (rec["block_q"], rec["block_k"]) == (64, 64)
    assert rec["key"] == "q64.kv64.d8.float32.causal.cpu-cpu"
    trials = port_metrics.value("hvd_flash_tuner_trials_total")
    assert trials - before == 1
    fa.flash_attention(q, q, q, causal=True)
    assert port_metrics.value("hvd_flash_tuner_trials_total") == trials


# ---------------------------------------------------- multi-rank worlds ---

@pytest.fixture
def shared_world(monkeypatch):
    monkeypatch.setattr(basics, "is_shared_world", lambda: True)
    monkeypatch.setattr(port, "_synced_generation", basics.init_generation())


def _synced_key():
    return port.shape_key(256, 256, 64, "float32", True,
                          port._device_kind("cpu"))


def test_synced_view_overrides_local_env_gate(shared_world, monkeypatch):
    key = _synced_key()
    monkeypatch.setattr(port, "_synced_cache",
                        {key: _rec(port, key, 256, 512)})
    assert port.best_blocks(256, 256, 64, "float32", True,
                            device="cpu") == (256, 512)
    monkeypatch.setattr(port, "_synced_cache", None)
    assert port.best_blocks(256, 256, 64, "float32", True,
                            device="cpu") is None


def test_local_sync_optout_env_cannot_split_the_read_path(
        shared_world, tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_FLASH_TUNE_SYNC", "0")
    monkeypatch.setenv("HVD_FLASH_TUNE_CACHE", str(tmp_path / "c.jsonl"))
    key = _synced_key()
    monkeypatch.setattr(port, "_synced_cache",
                        {key: _rec(port, key, 256, 512)})
    monkeypatch.setattr(port, "_synced_optout", False)
    assert port.best_blocks(256, 256, 64, "float32", True,
                            device="cpu") == (256, 512)
    assert port.world_synced_view_active()
    monkeypatch.setattr(port, "_synced_optout", True)
    monkeypatch.setenv("HVD_FLASH_TUNE", "cache")
    port.append_record(_rec(port, key, 128, 128))
    _fresh(port)
    assert port.best_blocks(256, 256, 64, "float32", True,
                            device="cpu") == (128, 128)
    assert not port.world_synced_view_active()


def test_flash_attention_consults_synced_view_without_local_env(
        shared_world, monkeypatch):
    """With this rank's HVD_FLASH_TUNE unset, the port's tiles still come
    from the synced view, through ``flash_attention``'s own resolution."""
    key = port.shape_key(64, 64, 8, "float32", True,
                         port._device_kind("cpu"))
    monkeypatch.setattr(port, "_synced_cache",
                        {key: _rec(port, key, 32, 16)})
    assert port.world_synced_view_active()
    assert fa.resolve_blocks(64, 64, 8, torch.float32, True, "cpu") == \
        (32, 16)
    seen = []
    real = fa.resolve_blocks

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(fa, "resolve_blocks", spy)
    q = torch.tensor(np.random.RandomState(0).randn(1, 64, 1, 8),
                     dtype=torch.float32)
    assert fa.flash_attention(q, q, q, causal=True).shape == q.shape
    assert seen == [(32, 16)]


@pytest.fixture(scope="module")
def np2_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flash_sync")
    return start_runs(
        os.path.join(HERE, "torch_port_flash_sync_worker.py"),
        [((mode,), 2, [mode]) for mode in ("sync", "optout0", "optout1")],
        tmp, env=lambda key: {"HVD_FLASH_SYNC_CACHE_DIR": str(
            tmp / key[0])}, jax=False)


def _verdicts(np2_runs, mode):
    per_rank = [json.loads(str(r["verdict"])) for r in np2_runs[(mode,)]]
    assert per_rank[0] == per_rank[1]
    return [tuple(tuple(x) if isinstance(x, list) else x for x in v)
            for v in per_rank[0]]


@pytest.mark.parametrize("mode", ["sync", "optout1"])
def test_np2_divergent_caches_adopt_rank0_winner(np2_runs, mode):
    """Every rank answers rank 0's winner (its own cache says otherwise on
    rank 1), a shape no rank has and a cold tune are None on both, and a
    rank whose own HVD_FLASH_TUNE is unset still reads the synced view.
    Rank 1's own HVD_FLASH_TUNE_SYNC=0 (``optout1``) changes nothing."""
    want = ((256, 512), None, None, (256, 512), True)
    assert _verdicts(np2_runs, mode) == [want, want]


def test_np2_optout_rides_the_broadcast(np2_runs):
    """Rank 0's HVD_FLASH_TUNE_SYNC=0 reaches every rank: each reads its
    own cache."""
    assert _verdicts(np2_runs, "optout0") == [
        ((256, 512), None, None, None, False),
        ((128, 128), None, None, None, False)]
