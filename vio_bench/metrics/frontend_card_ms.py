"""Card time a tracked frame of the front end's programs (the published and
the unpublished step), from the harness's CUDA events around each call."""

from vio_bench.metrics._spans import total_ms


def read(run):
    got = total_ms(run, ("frontend_",))
    return got[0] / got[1] if got and got[1] else None
