"""Scene generators of the benchmark: each module makes the inputs of the
scenes of one kind of configuration from the configuration's file, the
cell's workload file and the run's seed.  Frozen copies: later changes to
the program leave them as they are."""


def seed_words(seed: int, *more: int) -> list[int]:
    """``seed`` and further integers as the non-negative words that
    ``numpy.random.default_rng`` takes: any whole number, negative or
    beyond 64 bits, gives its own stream."""
    return [seed % (1 << 64), *(m % (1 << 64) for m in more)]
