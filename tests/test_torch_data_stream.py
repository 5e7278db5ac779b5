"""The port's streaming input pipeline (``repro_torch.data``: shard
source -> checksum-verified shard cache -> background prefetch) against
``repro.data``: the counterparts of the pipeline, source and cache tests
of tests/test_train_async.py, shards and cache directories identical
across the two packages, and the trainer's double buffer. Ordering and
bytes are pinned; wall-clock bounds are not."""
import dataclasses
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import data as jax_data  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import (  # noqa: E402
    CacheCorruptError,
    CacheMismatchError,
    Pipeline,
    Prefetcher,
    ShardCache,
    SyntheticShardSource,
    check_cache,
)
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

CFG = get_config("gemma-7b").reduced()
REF_CFG = jax_get_config("gemma-7b").reduced()


def _source(n_batches=10, shard_size=4, seed=0, batch=2, seq=16, ref=False):
    cls = jax_data.SyntheticShardSource if ref else SyntheticShardSource
    return cls(REF_CFG if ref else CFG, batch=batch, seq=seq,
               n_batches=n_batches, shard_size=shard_size, seed=seed)


def _assert_same_stream(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# --------------------------------------------------------------------------- #
# Pipeline and Prefetcher.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_batches,shard_size,depth,start", [
    (0, 1, 1, 0), (1, 1, 2, 0), (7, 3, 2, 0), (7, 3, 1, 4), (10, 4, 3, 9),
    (10, 4, 5, 10), (23, 9, 2, 13), (12, 5, 4, 25), (6, 6, 2, 5)])
def test_pipeline_equals_sync_iterator(n_batches, shard_size, depth, start):
    src = _source(n_batches=n_batches, shard_size=shard_size, batch=1, seq=8)
    start = min(start, n_batches)
    want = list(src.batches(start=start))
    with Pipeline(src, prefetch_depth=depth, start_batch=start) as pipe:
        _assert_same_stream(list(pipe), want)


def test_pipeline_restarts_from_start_batch():
    src = _source(n_batches=6, shard_size=2)
    pipe = Pipeline(src, start_batch=3)
    first = list(pipe)
    again = list(pipe)  # a second __iter__ restarts at the same position
    pipe.close()
    _assert_same_stream(first, list(src.batches(start=3)))
    _assert_same_stream(again, first)
    assert pipe.wait_ms == 0.0  # closed
    with pytest.raises(ValueError, match="start_batch"):
        Pipeline(src, start_batch=-1)


def test_prefetcher_forwards_worker_exception():
    def boom():
        yield {"x": np.zeros(1)}
        raise RuntimeError("source died")

    pf = Prefetcher(boom(), depth=2)
    assert next(pf) is not None
    with pytest.raises(RuntimeError, match="source died"):
        for _ in pf:
            pass
    with pytest.raises(StopIteration):  # ended: no hang on a later next()
        next(pf)


def test_prefetcher_close_unblocks_full_queue():
    pf = Prefetcher(({"i": np.asarray(i)} for i in range(10_000)), depth=1)
    next(pf)
    time.sleep(0.05)  # let the worker fill (and block on) the queue
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_rejects_bad_depth_and_keeps_order():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(()), depth=0)
    with Prefetcher(iter(range(50)), depth=2) as pf:
        assert list(pf) == list(range(50))
        assert pf.batches == 50 and pf.wait_ms >= 0.0


# --------------------------------------------------------------------------- #
# Shard source: independent per-shard RNG, byte-identical to the reference.
# --------------------------------------------------------------------------- #
def test_shard_source_shards_are_independent_and_deterministic():
    src = _source(n_batches=10, shard_size=4)
    _assert_same_stream(src.shard(2), _source(n_batches=10,
                                              shard_size=4).shard(2))
    assert [len(src.shard(i)) for i in range(src.n_shards)] == [4, 4, 2]
    other = _source(n_batches=10, shard_size=4, seed=7)
    assert not np.array_equal(src.shard(0)[0]["tokens"],
                              other.shard(0)[0]["tokens"])
    with pytest.raises(IndexError):
        src.shard(3)
    with pytest.raises(ValueError, match="shard_size"):
        _source(shard_size=0)


@pytest.mark.parametrize("seed", [0, 5])
def test_shards_equal_the_reference_bitwise(seed):
    src = _source(n_batches=7, shard_size=3, seed=seed, batch=3, seq=24)
    ref = _source(n_batches=7, shard_size=3, seed=seed, batch=3, seq=24,
                  ref=True)
    assert src.fingerprint() == ref.fingerprint()
    assert src.n_shards == ref.n_shards
    for i in range(src.n_shards):
        _assert_same_stream(src.shard(i), ref.shard(i))
    _assert_same_stream(list(src.batches(start=4)),
                        list(ref.batches(start=4)))


def test_shard_source_seek_matches_full_stream():
    src = _source(n_batches=11, shard_size=3)
    full = list(src.batches())
    for start in (0, 1, 3, 5, 10, 11):
        _assert_same_stream(list(src.batches(start=start)), full[start:])


# --------------------------------------------------------------------------- #
# Shard cache: verified reads, loud failures.
# --------------------------------------------------------------------------- #
class _CountingSource:
    """Source wrapper that counts generation calls (read-through check)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0
        self.n_shards = inner.n_shards
        self.shard_size = inner.shard_size

    def shard(self, i):
        self.calls += 1
        return self.inner.shard(i)

    def fingerprint(self):
        return self.inner.fingerprint()


def test_cache_roundtrip_and_read_through(tmp_path):
    src = _CountingSource(_source(n_batches=7, shard_size=3))
    d = str(tmp_path / "cache")
    cache = ShardCache(d).ensure(src)
    assert src.calls == src.n_shards  # built once
    for i in range(cache.n_shards):
        _assert_same_stream(cache.shard(i), src.inner.shard(i))
    src.calls = 0
    again = ShardCache(d).ensure(src)  # second open: disk only
    _assert_same_stream(again.shard(1), src.inner.shard(1))
    assert src.calls == 0
    assert check_cache(d).ok
    assert again.fingerprint() == src.fingerprint()


def test_cache_detects_corruption(tmp_path):
    src = _source(n_batches=6, shard_size=3)
    d = str(tmp_path / "cache")
    ShardCache(d).ensure(src)
    shard_file = os.path.join(d, sorted(
        f for f in os.listdir(d) if f.startswith("shard_"))[0])
    blob = bytearray(open(shard_file, "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # flip one byte mid-file
    open(shard_file, "wb").write(bytes(blob))
    status = check_cache(d)
    assert not status.ok and status.corrupt
    with pytest.raises(CacheCorruptError, match="delete the directory"):
        ShardCache(d).ensure(src)
    ShardCache(d).ensure(src, verify=False)  # an explicit opt-out opens it


def test_cache_detects_missing_shard(tmp_path):
    src = _source(n_batches=6, shard_size=3)
    d = str(tmp_path / "cache")
    ShardCache(d).ensure(src)
    os.remove(os.path.join(d, "shard_00001.npz"))
    assert check_cache(d).missing == ("shard_00001.npz",)
    with pytest.raises(CacheCorruptError):
        ShardCache(d).ensure(src)


def test_cache_rejects_mismatched_source(tmp_path):
    d = str(tmp_path / "cache")
    ShardCache(d).ensure(_source(n_batches=6, seed=0))
    with pytest.raises(CacheMismatchError, match="different source"):
        ShardCache(d).ensure(_source(n_batches=6, seed=1))


def test_partial_build_without_ledger_rebuilds(tmp_path):
    src = _source(n_batches=6, shard_size=3)
    d = str(tmp_path / "cache")
    ShardCache(d).ensure(src)
    os.remove(os.path.join(d, "ledger.json"))
    assert not check_cache(d).exists
    counting = _CountingSource(src)
    ShardCache(d).ensure(counting)
    assert counting.calls == src.n_shards  # rebuilt from the source


def test_pipeline_serves_from_cache(tmp_path):
    src = _CountingSource(_source(n_batches=8, shard_size=4))
    d = str(tmp_path / "cache")
    with Pipeline(src, cache_dir=d) as pipe:
        first = list(pipe)
    src.calls = 0
    with Pipeline(src, cache_dir=d, start_batch=5) as pipe:  # disk only
        _assert_same_stream(list(pipe), first[5:])
    assert src.calls == 0


@pytest.mark.parametrize("builder", ["reference", "port"])
def test_cache_dir_is_shared_across_packages(tmp_path, builder):
    """A cache built by one package verifies and serves in the other:
    same files, same ledger, same batches."""
    d = str(tmp_path / "cache")
    port_src = _source(n_batches=7, shard_size=3)
    ref_src = _source(n_batches=7, shard_size=3, ref=True)
    if builder == "reference":
        jax_data.ShardCache(d).ensure(ref_src)
        reader, src = ShardCache(d).ensure(port_src), port_src
    else:
        ShardCache(d).ensure(port_src)
        reader, src = jax_data.ShardCache(d).ensure(ref_src), ref_src
    assert jax_data.check_cache(d).ok and check_cache(d).ok
    for i in range(src.n_shards):
        _assert_same_stream(reader.shard(i), src.shard(i))


# --------------------------------------------------------------------------- #
# The trainer's double buffer and the pipeline as its input.
# --------------------------------------------------------------------------- #
def test_double_buffer_histories_are_equal(tmp_path):
    cfg = dataclasses.replace(CFG, dtype="float32")
    src = SyntheticShardSource(cfg, batch=2, seq=16, n_batches=4,
                               shard_size=2)
    hists = []
    for double_buffer in (False, True):
        tr = Trainer(cfg, TrainerConfig(total_steps=4, log_every=0,
                                        double_buffer=double_buffer),
                     device="cpu")
        with Pipeline(src, cache_dir=str(tmp_path / "cache"),
                      prefetch_depth=2) as pipe:
            hists.append(tr.fit(pipe))
        assert all(r["data_wait_ms"] >= 0.0 for r in hists[-1])
    key = lambda h: [(r["step"], r["loss"], r["nll"]) for r in h]  # noqa: E731
    assert key(hists[0]) == key(hists[1])
    assert len(hists[0]) == 4


def test_double_buffer_stages_one_batch_ahead():
    """Batch i + 1 is drawn from the input before step i runs."""
    tr = Trainer(CFG, TrainerConfig(total_steps=3, log_every=0,
                                    double_buffer=True), device="cpu")
    drawn, seen = [], []

    def batches():
        for i, b in enumerate(data.synthetic_lm_batches(CFG, batch=2, seq=8,
                                                        steps=3)):
            drawn.append(i)
            yield b

    step = tr._train_step

    def spy(state, batch):
        seen.append(len(drawn))
        return step(state, batch)

    tr._train_step = spy
    tr.fit(batches())
    assert seen == [2, 3, 3]
