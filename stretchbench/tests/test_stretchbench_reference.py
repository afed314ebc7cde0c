"""The plain reference against loops written out one tuple at a time."""

from collections import Counter

import numpy as np

from stretchbench.reference import bandjoin, gate, wordcount


def test_band_join_equals_a_pair_loop():
    rng = np.random.default_rng(3)
    n = 400
    tau = np.sort(rng.integers(0, 2000, n))
    src = rng.integers(0, 2, n)
    pay = rng.uniform(1, 400, (n, 4)).astype(np.float32)
    rel = np.repeat(np.arange(8), n // 8)         # 8 ticks of 50
    j = bandjoin.BandJoin(tau, src, pay, rel, ws=300, wa=1, band=10.0,
                          n_attrs=2)
    for t in range(8):
        want = Counter()
        new = np.nonzero(rel == t)[0]
        for x in new:
            for y in range(n):
                earlier = rel[y] < t or (rel[y] == t and y < x)
                if (earlier and src[y] != src[x]
                        and abs(int(tau[x]) - int(tau[y])) <= 300
                        and all(abs(np.float32(pay[x, a] - pay[y, a])) <= 10
                                for a in range(2))):
                    want[bandjoin.pair_key(max(tau[x], tau[y]) + 1, pay[x],
                                           pay[y])] += 1
        assert j.expected(t) == want
        assert j.comparisons(t) == sum(
            1 for x in new for y in range(n)
            if (rel[y] < t or (rel[y] == t and y < x))
            and src[y] != src[x] and abs(int(tau[x]) - int(tau[y])) <= 300)


def test_bfloat16_control_changes_the_pairs():
    rng = np.random.default_rng(4)
    n = 2000
    tau = np.arange(n)
    pay = rng.uniform(1, 10000, (n, 4)).astype(np.float32)
    pay[1::2, :2] = pay[0::2, :2] + rng.uniform(-14, 14, (n // 2, 2))
    j = bandjoin.BandJoin(tau, np.arange(n) % 2, pay, np.arange(n) // 100,
                          ws=10**6, wa=1, band=10.0, n_attrs=2)
    assert any(j.expected(t) != j.expected(t, "bfloat16")
               for t in range(n // 100))


def test_wordcount_equals_a_tuple_loop():
    rng = np.random.default_rng(5)
    ticks = []
    t0 = 0
    for _ in range(10):
        tau = np.sort(t0 + rng.integers(0, 800, 60))
        t0 = int(tau.max()) + 1
        keys = rng.integers(-1, 20, (60, 3)).astype(np.int32)
        ticks.append((tau, keys))
    closes = wordcount.closing([(int(t.min()), int(t.max()))
                                for t, _ in ticks], 1000, 2000)
    tau = np.concatenate([t for t, _ in ticks])
    keys = np.concatenate([k for _, k in ticks])
    between = lambda a, b: (tau, keys)
    seen = set()
    for i, (lo, hi) in enumerate(closes):
        got = wordcount.expected((lo, hi), 1000, 2000, between)
        want = Counter()
        for l in range(lo, hi):
            assert l not in seen
            seen.add(l)
            counts = Counter()
            for t, ks in zip(tau, keys):
                if l * 1000 <= t < l * 1000 + 2000:
                    for k in set(int(k) for k in ks if k >= 0):
                        counts[k] += 1
            for k, c in counts.items():
                want[(l * 1000 + 2000, k, c)] += 1
        assert got == want
        # a window closes once the watermark reaches its end
        wmark = int(ticks[i][0].max())
        assert all(l * 1000 + 2000 <= wmark for l in range(lo, hi))


def test_gate_releases_up_to_the_slower_source_and_switches():
    keys = lambda ids: np.zeros((len(ids), 1), np.int32)
    m = gate.GateModel(2, [0, 0], np.zeros(4, np.int64), 4, keys)
    # source 1 lags: its frontier bounds the watermark
    ids, taus, sw, load = m.step(np.arange(4), np.array([1, 2, 3, 4]),
                                 np.array([0, 0, 1, 0]))
    assert set(ids) == {0, 1, 2} and not sw and load[0] == 3
    fmu = np.arange(4) % 2
    ids, taus, sw, load = m.step(np.arange(4, 6), np.array([5, 6]),
                                 np.array([1, 1]),
                                 inject={"epoch": 1, "fmu": fmu})
    # W = 4: tuple 3 and the controls (stamped 4 and 3) are released,
    # gamma = 4, no data past it yet
    assert set(ids) == {3} and not sw and load[0] == 1
    ids, taus, sw, load = m.step(np.array([6]), np.array([7]), np.array([0]))
    # W = 6: tuples 4 and 5 reach past gamma: the switch, counted under
    # the old key map
    assert set(ids) == {4, 5} and sw and load[0] == 2
    assert m.last_switch[0] == 4 and (m.fmu == fmu).all()
