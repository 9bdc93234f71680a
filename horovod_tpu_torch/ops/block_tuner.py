"""The flash-attention tile tuner with its journaled cache.

Port of ``horovod_tpu/ops/block_tuner.py``. ``best_blocks`` answers the
tiles of one attention shape from a persistent cache keyed by the shape
and the device; on a miss under ``HVD_FLASH_TUNE=1`` it times one
fwd+bwd step of ``flash_attention`` for each candidate pair on synthetic
inputs of the live shape and journals the winner.
``HVD_FLASH_TUNE=cache`` reads cached winners and never measures. An
explicit ``block_q=``/``block_k=`` or ``HVD_FLASH_BLOCK_Q/K`` wins over
the tuner (``ops/flash_attention.resolve_blocks``).

The cache is the reference's append-only JSONL file, record for record
(``CACHE_VERSION``, one line per winner written with ``O_APPEND`` and
``fsync``, a torn tail folded away, last record wins), so each package
reads a cache that the other wrote. The key names the dtype as the
reference does (``bfloat16``) and the device as ``<platform>-<kind>``:
``cpu-cpu`` on the CPU, as JAX names it, ``gpu-<card's name>`` on a card.

On a card the candidates are the tiles the kernels compile
(``flash_attention.COMPILED_TILES``; today one, so the tuner has one
candidate to time). On the CPU they are the reference's, which the plain
version ignores.

In a multi-rank world the tiles are rank 0's: ``sync_cache_across_world``
(called by ``common/basics.init`` at every world formation, elastic
reinits included) broadcasts rank 0's folded cache, and ``best_blocks``
then answers from that view alone, with no collective at lookup time.
Cold tuning is refused there: misses keep the defaults on every rank.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch")

CACHE_VERSION = 1

# One trial = one timed (block_q, block_k) candidate for one shape key.
_M_TRIALS = _metrics.counter(
    "hvd_flash_tuner_trials_total",
    "Flash-attention block-size candidates timed by the autotuner "
    "(one per (block_q, block_k) pair per tuned shape).")

DEFAULT_CANDIDATES = (128, 256, 512)
DEFAULT_ITERS = 3

# This process's fold of the cache file plus the winners it tuned.
_mem_cache: Dict[str, Dict] = {}
_mem_cache_path: Optional[str] = None

# Rank 0's cache view for this world (sync_cache_across_world), with the
# init generation it belongs to and rank 0's HVD_FLASH_TUNE_SYNC=0.
_synced_cache: Optional[Dict[str, Dict]] = None
_synced_generation: Optional[int] = None
_synced_optout = False
_warned_cold_multirank = False


def tune_mode() -> str:
    """Resolved ``HVD_FLASH_TUNE``: '' (off), '1' (tune on miss) or
    'cache' (cached winners only)."""
    mode = os.environ.get("HVD_FLASH_TUNE", "").strip().lower()
    if mode in ("", "0", "off", "false"):
        return ""
    if mode == "cache":
        return "cache"
    return "1"


def cache_path() -> str:
    """``HVD_FLASH_TUNE_CACHE`` or ``~/.cache/horovod_tpu_torch/``."""
    path = os.environ.get("HVD_FLASH_TUNE_CACHE", "")
    if path:
        return path
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "horovod_tpu_torch", "flash_blocks.jsonl")


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``bfloat16``, as numpy names a JAX dtype; a
    string passes through."""
    return str(dtype).replace("torch.", "")


def shape_key(seq_q: int, seq_kv: int, head_dim: int, dtype, causal: bool,
              device_kind: str) -> str:
    """Cache key for one attention shape on one device kind. Batch and
    head count are absent: they scale the grid, not a tile's work."""
    return "q%d.kv%d.d%d.%s.%s.%s" % (
        seq_q, seq_kv, head_dim, _dtype_name(dtype),
        "causal" if causal else "full",
        str(device_kind).replace(" ", "_"))


def load_cache(path: Optional[str] = None) -> Dict[str, Dict]:
    """Fold the JSONL journal into {key: winner record}, last wins. Torn
    tails and garbage lines are skipped; an unreadable file is an empty
    cache."""
    path = path or cache_path()
    out: Dict[str, Dict] = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if (isinstance(rec, dict)
                        and rec.get("version") == CACHE_VERSION
                        and isinstance(rec.get("key"), str)
                        and isinstance(rec.get("block_q"), int)
                        and isinstance(rec.get("block_k"), int)):
                    out[rec["key"]] = rec
    except OSError:
        pass
    return out


def append_record(rec: Dict, path: Optional[str] = None) -> None:
    """Journal one winner as one ``O_APPEND`` line, then ``fsync``: the
    appends of concurrent tuners interleave whole lines. A torn tail left
    by a writer that died mid-line is closed with a newline first, so
    that it stays a line of its own and this record parses."""
    path = path or cache_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    line = json.dumps(rec, sort_keys=True) + "\n"
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            if fh.tell():
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    line = "\n" + line
    except OSError:
        pass
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode("utf-8"))
        os.fsync(fd)
    finally:
        os.close(fd)


def _cached(key: str, path: str) -> Optional[Dict]:
    global _mem_cache, _mem_cache_path
    if _mem_cache_path != path:
        _mem_cache = load_cache(path)
        _mem_cache_path = path
    return _mem_cache.get(key)


def _device(device):
    """``device``, or the device of the last ``init`` (the card before
    any ``init``)."""
    import torch

    from horovod_tpu_torch.common import basics

    return torch.device(device if device is not None
                        else basics.init_device())


def _clamp_to_compiled(c: int) -> int:
    """The largest compiled tile at most ``c``, else the smallest."""
    from horovod_tpu_torch.ops.flash_attention import COMPILED_TILES

    below = [t for t in COMPILED_TILES if t <= c]
    return max(below) if below else min(COMPILED_TILES)


def candidate_pairs(seq_q: int, seq_kv: int, candidates=None,
                    device=None) -> List[Tuple[int, int]]:
    """(block_q, block_k) sweep grid, deduplicated. On the CPU each
    candidate is clamped to the sequence lengths, as in the reference; on
    a card (``device``, default that of the last ``init``) to the tiles
    the kernels compile, which handle a ragged sequence themselves."""
    if candidates is None:
        raw = os.environ.get("HVD_FLASH_TUNE_CANDIDATES", "")
        candidates = [int(c) for c in raw.split(",") if c.strip()] or \
            list(DEFAULT_CANDIDATES)
    if _device(device).type != "cpu":
        qs = ks = sorted({_clamp_to_compiled(c) for c in candidates})
    else:
        qs = sorted({min(c, max(seq_q, 1)) for c in candidates})
        ks = sorted({min(c, max(seq_kv, 1)) for c in candidates})
    return [(bq, bk) for bq in qs for bk in ks]


def _default_time_fn(seq_q, seq_kv, head_dim, dtype, causal, batch, heads,
                     iters, device):
    """``time_fn(block_q, block_k) -> seconds`` of one fwd+bwd step of the
    port's ``flash_attention`` on inputs of the live shape, after one
    untimed warm-up: CUDA events on a card, the host clock on the CPU."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.RandomState(0)
    dtype = getattr(torch, _dtype_name(dtype))
    q, k, v = (torch.tensor(rng.randn(batch, s, heads, head_dim),
                            dtype=torch.float32).to(device=device,
                                                    dtype=dtype)
               .requires_grad_()
               for s in (seq_q, seq_kv, seq_kv))
    cuda = device.type == "cuda"

    def step(bq, bk):
        out = flash_attention(q, k, v, causal=causal, block_q=bq,
                              block_k=bk)
        torch.autograd.grad(out.float().sum(), (q, k, v))

    def time_fn(bq, bk):
        n = max(iters, 1)
        step(bq, bk)  # warm-up: builds and loads the kernels
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                step(bq, bk)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3 / n
        t0 = time.perf_counter()
        for _ in range(n):
            step(bq, bk)
        return (time.perf_counter() - t0) / n

    return time_fn


def tune(seq_q: int, seq_kv: int, head_dim: int, dtype, causal: bool,
         *, candidates=None, iters: Optional[int] = None,
         batch: int = 1, heads: int = 1, device=None,
         time_fn=None) -> Tuple[int, int]:
    """Time each candidate pair for one shape and journal the winner.
    ``time_fn(block_q, block_k) -> seconds`` may be injected; a candidate
    whose ``time_fn`` raises loses. ``device`` is the device to time on
    and the key's device (default: that of the last ``init``)."""
    device = _device(device)
    if iters is None:
        iters = int(os.environ.get("HVD_FLASH_TUNE_ITERS",
                                   str(DEFAULT_ITERS)))
    pairs = candidate_pairs(seq_q, seq_kv, candidates, device)
    if time_fn is None:
        time_fn = _default_time_fn(seq_q, seq_kv, head_dim, dtype, causal,
                                   batch, heads, iters, device)
    results = []
    for bq, bk in pairs:
        _M_TRIALS.inc()
        try:
            dt = time_fn(bq, bk)
        except Exception as e:  # noqa: BLE001 — a failing candidate loses
            logger.debug("flash tuner: bq=%d bk=%d failed: %s", bq, bk, e)
            continue
        results.append((dt, bq, bk))
    if not results:
        raise RuntimeError(
            "flash block tuner: every candidate failed for shape "
            "q=%d kv=%d d=%d %s" % (seq_q, seq_kv, head_dim,
                                    _dtype_name(dtype)))
    results.sort()
    dt, bq, bk = results[0]
    key = shape_key(seq_q, seq_kv, head_dim, dtype, causal,
                    _device_kind(device))
    rec = {"version": CACHE_VERSION, "key": key, "block_q": bq,
           "block_k": bk, "ms_per_step": round(dt * 1e3, 4),
           "trials": len(results), "iters": iters}
    append_record(rec)
    _mem_cache[key] = rec
    logger.info("flash tuner: %s -> block_q=%d block_k=%d (%.3f ms)",
                key, bq, bk, dt * 1e3)
    return bq, bk


def _device_kind(device=None) -> str:
    """``<platform>-<kind>``: ``cpu-cpu``, or ``gpu-`` and the card's name
    (JAX's platform and device kind of the same device)."""
    import torch

    device = _device(device)
    if device.type == "cuda":
        return "gpu-%s" % torch.cuda.get_device_name(device)
    return "%s-%s" % (device.type, device.type)


def best_blocks(seq_q: int, seq_kv: int, head_dim: int, dtype,
                causal: bool, *, batch: int = 1, heads: int = 1,
                device=None) -> Optional[Tuple[int, int]]:
    """Tuned (block_q, block_k) for the live shape, or None.

    A cache hit wins; on a miss ``HVD_FLASH_TUNE=1`` tunes and journals,
    ``HVD_FLASH_TUNE=cache`` returns None. In a multi-rank world the
    answer comes from rank 0's synced view alone, whatever this rank's
    own ``HVD_FLASH_TUNE``, unless rank 0 opted the world out."""
    mode = tune_mode()
    if _multi_rank_world() and not _world_opted_out():
        if _synced_view() is None and not mode:
            return None
        key = shape_key(seq_q, seq_kv, head_dim, dtype, causal,
                        _device_kind(device))
        return _best_blocks_synced(key, mode)
    if not mode:
        return None
    path = cache_path()
    key = shape_key(seq_q, seq_kv, head_dim, dtype, causal,
                    _device_kind(device))
    hit = _cached(key, path)
    if hit is not None:
        return hit["block_q"], hit["block_k"]
    if mode == "cache":
        return None
    return tune(seq_q, seq_kv, head_dim, dtype, causal, batch=batch,
                heads=heads, device=device)


def _multi_rank_world() -> bool:
    from horovod_tpu_torch.common import basics

    return basics.is_shared_world()


def _sync_enabled() -> bool:
    """This process's ``HVD_FLASH_TUNE_SYNC``: read by rank 0 alone, when
    it builds the sync's payload. Reads go by ``_world_opted_out``."""
    return os.environ.get("HVD_FLASH_TUNE_SYNC", "1") != "0"


def _world_opted_out() -> bool:
    """True when rank 0 had ``HVD_FLASH_TUNE_SYNC=0`` at this world's
    formation (carried by the sync's broadcast)."""
    from horovod_tpu_torch.common.basics import init_generation

    return _synced_generation == init_generation() and _synced_optout


def sync_cache_across_world() -> None:
    """Broadcast rank 0's folded cache to every rank of the world. Every
    rank takes part whatever its own settings; rank 0's decide the
    payload: its opt-out, and its cache when it tunes. No-op unless the
    world is shared."""
    global _synced_cache, _synced_generation, _synced_optout
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.objects import broadcast_object

    if not basics.is_shared_world():
        return
    payload = {"optout": False, "cache": None}
    if basics.rank() == 0:
        if not _sync_enabled():
            payload["optout"] = True
        elif tune_mode():
            payload["cache"] = load_cache()
    payload = broadcast_object(payload, root_rank=0,
                               name="flash_tune.cache_sync")
    _synced_optout = bool(payload["optout"])
    _synced_cache = payload["cache"]
    _synced_generation = basics.init_generation()
    if _synced_cache is not None:
        logger.info("flash tuner: synced %d cached winner(s) from rank 0",
                    len(_synced_cache))


def _synced_view() -> Optional[Dict[str, Dict]]:
    """The synced cache when it belongs to this world, else None."""
    from horovod_tpu_torch.common.basics import init_generation

    if _synced_generation != init_generation():
        return None
    return _synced_cache


def world_synced_view_active() -> bool:
    """True when this rank must consult rank 0's synced view even with its
    own ``HVD_FLASH_TUNE`` unset."""
    return (_multi_rank_world() and not _world_opted_out()
            and _synced_view() is not None)


def _best_blocks_synced(key: str, mode: str) -> Optional[Tuple[int, int]]:
    """Lookup in the synced view: local, the same on every rank. A miss
    keeps the defaults: a per-rank sweep would pick divergent tiles."""
    global _warned_cold_multirank

    rec = (_synced_view() or {}).get(key)
    if rec is not None:
        return rec["block_q"], rec["block_k"]
    if mode == "1" and not _warned_cold_multirank:
        _warned_cold_multirank = True
        logger.warning(
            "flash tuner: HVD_FLASH_TUNE=1 in a multi-rank world: cold "
            "tuning is refused; shape %s keeps the default tiles on every "
            "rank. Warm the cache from one process and relaunch with "
            "HVD_FLASH_TUNE=cache", key)
    return None


def tuned_snapshot() -> Dict[str, Dict]:
    """The folded cache, for benchmarks and diagnostics."""
    return dict(load_cache())
