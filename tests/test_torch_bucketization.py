"""The port's copy of window bucketization and GNMT's input plumbing
against ``repro.data``: ``window_bucketize``, ``pad_batch``,
``padding_waste`` and ``bucketized_batches`` give the reference's batches
bit for bit for several seeds, windows and batch sizes; the round-robin
host split and ``prefetch`` give the reference's streams, and the port's
``prefetch`` also forwards its source's exception and stops its thread
when closed."""
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.data import bucketization as jax_bk  # noqa: E402
from repro.data import pipeline as jax_pipe  # noqa: E402
from repro_torch.data import bucketization as bk  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402


def _examples(seed, n, max_len=40, vocab=512):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(1, vocab, rng.integers(1, max_len)),
                       np.int32) for _ in range(n)]


CASES = [(0, 128, 8, 6), (1, 97, 16, 3), (2, 300, 32, 0), (3, 50, 7, 100),
         (4, 1, 4, 6)]  # seed, examples, batch, window


@pytest.mark.parametrize("seed,n,batch,window", CASES, ids=str)
def test_bucketize_pad_waste_and_batches_equal_reference(seed, n, batch,
                                                         window):
    ex = _examples(seed, n)
    lengths = [len(e) for e in ex]
    got = bk.window_bucketize(lengths, batch, window)
    want = jax_bk.window_bucketize(lengths, batch, window)
    assert got == want
    assert sorted(i for b in got for i in b) == list(range(n))
    for b in got:
        ls = [lengths[i] for i in b]
        assert len(b) <= batch and max(ls) - min(ls) <= window
    naive = [list(range(i, min(i + batch, n))) for i in range(0, n, batch)]
    for bs in (got, naive):
        assert bk.padding_waste(lengths, bs) == jax_bk.padding_waste(
            lengths, bs)
    for multiple in (1, 8):
        t, m = bk.pad_batch(ex[:5], pad_value=3, multiple=multiple)
        wt, wm = jax_bk.pad_batch(ex[:5], pad_value=3, multiple=multiple)
        assert t.dtype == wt.dtype and m.dtype == wm.dtype
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(m, wm)
    for s in (0, seed + 11):
        got_b = list(bk.bucketized_batches(ex, batch, window, seed=s))
        want_b = list(jax_bk.bucketized_batches(ex, batch, window, seed=s))
        assert len(got_b) == len(want_b) >= -(-n // batch)
        for (t, m), (wt, wm) in zip(got_b, want_b):
            assert t.dtype == wt.dtype and m.dtype == wm.dtype
            np.testing.assert_array_equal(t, wt)
            np.testing.assert_array_equal(m, wm)


@pytest.mark.parametrize("n,hosts", [(128, 4), (13, 4), (5, 8), (0, 3)])
def test_round_robin_hosts_equal_reference(n, hosts):
    ex = list(range(n))
    got = pipe.RoundRobinHostPipeline(ex, n_hosts=hosts)
    want = jax_pipe.RoundRobinHostPipeline(ex, n_hosts=hosts)
    for h in range(hosts):
        assert list(got.host_stream(h)) == list(want.host_stream(h))
    assert list(got.interleaved()) == list(want.interleaved()) == ex


def test_prefetch_yields_the_stream_in_order():
    ex = _examples(5, 64)
    stream = bk.bucketized_batches(ex, 8, window=4)
    got = list(pipe.prefetch(stream, size=2))
    want = list(jax_pipe.prefetch(
        jax_bk.bucketized_batches(ex, 8, window=4), size=2))
    assert len(got) == len(want)
    for (t, m), (wt, wm) in zip(got, want):
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(m, wm)
    assert list(pipe.prefetch(iter([]))) == []


def test_prefetch_forwards_errors_and_stops_when_closed():
    def boom():
        yield 1
        raise KeyError("source failed")

    it = pipe.prefetch(boom())
    assert next(it) == 1
    with pytest.raises(KeyError, match="source failed"):
        next(it)

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = pipe.prefetch(endless(), size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() == before
    n = len(produced)
    assert n <= 3 + 2 + 1  # consumed, queued, and the one being put
