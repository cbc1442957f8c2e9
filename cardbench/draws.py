"""Seeded draws of the traffic: the same seed gives the same inputs, and
every seed gives the same set of sizes in another order (stratified
draws), so that seeds change the order of the work and not its amount.
Seeds are any non-negative whole numbers (NumPy's generator takes
integers of any size)."""

import numpy as np


def rng(seed, stream=0):
    """A generator for one purpose (``stream``) of a run's seed."""
    return np.random.default_rng([int(seed), int(stream)])


def stratified(gen, lo, hi, strata, blocks):
    """``blocks`` blocks of ``strata`` values in [lo, hi): each block
    holds one uniform draw from each of ``strata`` equal sub-ranges, in a
    random order."""
    edges = np.linspace(lo, hi, strata + 1)
    out = []
    for _ in range(blocks):
        u = gen.random(strata)
        vals = edges[:-1] + u * (edges[1:] - edges[:-1])
        out.append(vals[gen.permutation(strata)])
    return np.concatenate(out)


def sorted_strata(gen, lo, hi, n):
    """``n`` sorted values in [lo, hi), one uniform draw in each of ``n``
    equal sub-ranges."""
    edges = np.linspace(lo, hi, n + 1)
    return edges[:-1] + gen.random(n) * (edges[1:] - edges[:-1])
