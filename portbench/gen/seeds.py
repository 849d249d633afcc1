"""One seed, many independent streams."""
import numpy as np


def streams(seed: int, n: int):
    """``n`` independent numpy generators drawn from ``seed`` (any whole
    number; negative ones and ones beyond 64 bits wrap)."""
    ss = np.random.SeedSequence(int(seed) % 2**64)
    return [np.random.default_rng(s) for s in ss.spawn(n)]


def pool(traffic: dict, seed: int):
    """(generators, order, own): one numpy generator for each of the
    traffic's ``distinct`` inputs, drawn from its ``pool_seed``; the order
    in which a run with ``seed`` takes them (job i takes input order[i mod
    distinct]); and a generator drawn from ``seed`` for the run's own
    input.

    Every seed runs the same pool in its window, so every seed does the
    same work: the inputs' content sets how many iterations ICP and its
    relatives take, and a pool drawn from the run's seed moved the rate by
    up to 15% between seeds. The seed sets the order, and with it the jobs
    that the comparison samples. The run's own input, new with every seed,
    is the set-up's warm job, outside the window; its output is compared
    too, so each seed checks data that no other seed saw."""
    n = traffic["distinct"]
    order, own = streams(seed, 2)
    return (streams(traffic["pool_seed"], n),
            [int(k) for k in order.permutation(n)], own)
