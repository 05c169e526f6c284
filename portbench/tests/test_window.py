"""The window's arithmetic: rates over all the time, percentiles over all
the solves, seeds, unions and gaps."""

import numpy as np
import pytest

from portbench.harness import window


def test_rate_is_over_all_the_time():
    # 7 solves of 10 restarts in a 2.5 s window, whatever their spread
    assert window.rate(7 * 10, 2.5) == 28.0
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


def test_p95_is_over_every_solve():
    rng = np.random.default_rng(0)
    for size in (1, 2, 20, 211, 1000):
        v = rng.exponential(size=size)
        assert window.percentile(v, 95) == pytest.approx(
            np.percentile(v, 95), rel=1e-12)
    # one slow solve of 200 moves the p95 only as its rank says
    v = [1.0] * 199 + [100.0]
    assert window.percentile(v, 95) == 1.0
    assert window.percentile(v, 100) == 100.0


def test_solve_seeds_repeat_and_differ():
    big = 2**33 + 5
    seeds = [window.solve_seed(big, i) for i in range(-1, 50)]
    assert seeds == [window.solve_seed(big, i) for i in range(-1, 50)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2**63 for s in seeds)
    assert window.solve_seed(big, 0) != window.solve_seed(big + 1, 0)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert window.union_seconds(iv, 0.0, 10.0) == 4.0
    assert window.gaps(iv, -1.0, 10.0) == [(-1.0, 0.0), (2.0, 3.0),
                                           (4.0, 9.0)]
    assert window.union_seconds([], 0.0, 1.0) == 0.0
    assert window.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
