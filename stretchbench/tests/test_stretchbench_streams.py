"""The frozen generators reproduce from a seed, equal the port's, and the
pool's replay keeps the stream sorted."""

import numpy as np
import pytest

from stretchbench import spec, streams
from stretchbench.tests import tiny


def test_tweets_equal_the_ports_generator():
    from repro_torch.data import datagen
    kw = dict(n_ticks=3, tick=64, words_per_tweet=6, vocab=50000,
              k_virt=65536, rate_per_tick=800)
    ours = streams.tweet_ticks(np.random.default_rng(11), **kw)
    port = list(datagen.tweets(np.random.default_rng(11), device="cpu", **kw))
    for a, b in zip(ours, port):
        assert (a["tau"] == b.tau.numpy()).all()
        assert (a["keys"] == b.keys.numpy()).all()
        assert (a["payload"] == b.payload.numpy()).all()


def test_scalejoin_equals_the_ports_generator():
    from repro_torch.data import datagen
    ours = streams.scalejoin_ticks(np.random.default_rng(5), n_ticks=3,
                                   tick=32, rate_t_per_s=2000.0,
                                   payload_width=4)
    port = list(datagen.scalejoin(np.random.default_rng(5), n_ticks=3,
                                  tick=32, k_virt=1, rate_t_per_s=2000.0,
                                  device="cpu"))
    for a, b in zip(ours, port):
        assert (a["tau"] == b.tau.numpy()).all()
        assert (a["src"] == b.source.numpy()).all()
        assert (a["payload"] == b.payload.numpy()).all()
        assert (a["keys"] == b.keys.numpy()).all()


def test_scalejoin_rows_follow_the_schema():
    """ScaleJoin's rows in seven float32 slots: x and a integers and y, b
    floats in [1, 10000]; R's z as five base-26 slots; S's double c as
    its float32 part and rest, its flag d, then zeros."""
    ticks = streams.scalejoin_ticks(np.random.default_rng(3), n_ticks=2,
                                    tick=256, rate_t_per_s=2000.0,
                                    payload_width=7, rows="scalejoin")
    for t in ticks:
        p, r = t["payload"], t["src"] == 0
        s = ~r
        assert p.dtype == np.float32 and p.shape == (256, 7)
        assert r.any() and s.any()
        assert (p[:, 0] == np.round(p[:, 0])).all()
        assert ((p[:, :2] >= 1) & (p[:, :2] <= 10000)).all()
        assert (p[r, 2:] == np.round(p[r, 2:])).all()
        assert ((p[r, 2:] >= 0) & (p[r, 2:] < 26 ** 4)).all()
        c = p[s, 2].astype(np.float64) + p[s, 3]
        assert ((c >= 1) & (c <= 10000)).all()
        assert set(np.unique(p[s, 4]).tolist()) <= {0.0, 1.0}
        assert (p[s, 5:] == 0).all()
    with pytest.raises(ValueError):
        streams.scalejoin_ticks(np.random.default_rng(3), n_ticks=1, tick=8,
                                rate_t_per_s=2000.0, payload_width=4,
                                rows="scalejoin")


@pytest.mark.parametrize("workload", ["q1-wordcount.zipf-max",
                                      "q1-wordcount.uniform-max",
                                      "q3-scalejoin.max"])
def test_stream_reproduces_from_a_large_seed(workload):
    c = tiny.cell(workload)
    kind = spec.kind(c["cfg"]["kind"])
    seed = 2**31 + 99
    a = kind.make_stream(c["cfg"], c["traffic"], seed)
    b = kind.make_stream(c["cfg"], c["traffic"], seed)
    other = kind.make_stream(c["cfg"], c["traffic"], seed + 1)
    n = 3 * len(a.pool)          # three cycles of the pool
    x, y = a.arrays(n), b.arrays(n)
    for f in ("tau", "src", "payload"):
        assert (x[f] == y[f]).all()
    assert all((a.tick(i)["keys"] == b.tick(i)["keys"]).all()
               for i in range(n))
    assert any((a.tick(0)[f] != other.tick(0)[f]).any()
               for f in ("tau", "keys", "payload", "src"))


def test_pool_replay_stays_sorted_per_source():
    c = tiny.cell("q3-scalejoin.max")
    s = spec.kind("bandjoin").make_stream(c["cfg"], c["traffic"], 1)
    a = s.arrays(3 * len(s.pool))
    for src in (0, 1):
        tau = a["tau"][a["src"] == src]
        assert (np.diff(tau.astype(np.int64)) >= 0).all()
    # each tick's event times lie strictly after the one before
    for i in range(1, 3 * len(s.pool)):
        assert s.tick(i)["tau"].min() > s.tick(i - 1)["tau"].max()


def test_uniform_words_have_no_hot_key():
    c = tiny.cell("q1-wordcount.uniform-max")
    c["cfg"]["k_virt"] = 65536
    s = spec.kind("wordcount").make_stream(c["cfg"], c["traffic"], 4)
    z = tiny.cell("q1-wordcount.zipf-max")
    z["cfg"]["k_virt"] = 65536
    sz = spec.kind("wordcount").make_stream(z["cfg"], z["traffic"], 4)
    top = lambda st: np.bincount(st.tick(0)["keys"].ravel()).max()
    assert top(s) < 10 < top(sz)
