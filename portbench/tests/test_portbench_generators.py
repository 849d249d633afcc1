"""The seeded generators repeat for a seed and differ across seeds."""
import numpy as np
import pytest

from portbench.gen.cloud import synthetic_cloud
from portbench.gen.seeds import streams
from portbench.gen.session import session_scan
from portbench.gen.slam import survey

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3, -4)
CLOUD = dict(n_points=5000, blobs=10, blob_sigma=0.0008, noise_frac=0.006,
             n_truth=512)
SESSION = dict(blob_range=[40.0, 45.0], range_sigma=0.001,
               noise_range=[5.0, 120.0], gate_zero=4, gate_far=4,
               far_range=1500.0, duplicates=16)


def cloud(seed):
    (rng,) = streams(seed, 1)
    c = CLOUD
    return synthetic_cloud(rng, c["n_points"], c["blobs"], c["blob_sigma"],
                           c["noise_frac"], c["n_truth"])


def session(seed):
    rc, rr = streams(seed, 2)
    return session_scan(rc, rr, CLOUD, SESSION)


def slam(seed):
    (rng,) = streams(seed, 1)
    return survey(rng, 6, 128, 4, 0.08, 0.5, 0.002)


@pytest.mark.parametrize("make", [cloud, session, slam])
@pytest.mark.parametrize("seed", SEEDS)
def test_a_seed_repeats(make, seed):
    for a, b in zip(make(seed), make(seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("make", [cloud, session, slam])
def test_seeds_differ(make):
    first = [make(s)[0] for s in SEEDS]
    for i in range(len(first)):
        for j in range(i + 1, len(first)):
            assert not np.array_equal(first[i], first[j])


@pytest.mark.parametrize("make", [cloud, session, slam])
def test_every_seed_gives_the_same_sizes(make):
    shapes = {tuple(a.shape for a in make(s)) for s in SEEDS}
    assert len(shapes) == 1


def test_session_gate_and_duplicates():
    motor, dist, truth = session(11)
    d = SESSION["duplicates"]
    assert np.array_equal(motor[-d:], motor[:d])
    assert np.array_equal(dist[-d:], dist[:d])
    assert (dist == 0).sum() >= SESSION["gate_zero"]
    assert (dist == SESSION["far_range"]).sum() >= SESSION["gate_far"]
    assert truth.shape == (CLOUD["blobs"], 3)


def test_streams_are_independent():
    a, b = streams(3, 2)
    assert a.integers(0, 2**62) != b.integers(0, 2**62)


def test_every_seed_runs_the_same_pool_in_its_own_order():
    """The window's pool is the same for every seed; the order and the
    run's own input (outside the pool) come from the seed."""
    from portbench.gen.seeds import pool

    traffic = {"distinct": 8, "pool_seed": 123}
    draws, orders, owns = {}, set(), set()
    for seed in SEEDS:
        rngs, order, own = pool(traffic, seed)
        assert sorted(order) == list(range(8))
        orders.add(tuple(order))
        draws[seed] = [r.integers(0, 2**62) for r in rngs]
        owns.add(int(own.integers(0, 2**62)))
        assert owns.isdisjoint(draws[seed])
    assert len({tuple(d) for d in draws.values()}) == 1
    assert len(orders) > 1
    assert len(owns) == len(SEEDS)
    assert pool(traffic, SEEDS[0])[1] == pool(traffic, SEEDS[0])[1]
    assert (pool(traffic, SEEDS[0])[2].integers(0, 2**62)
            == pool(traffic, SEEDS[0])[2].integers(0, 2**62))
