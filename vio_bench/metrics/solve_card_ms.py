"""Card time a solve of the estimator's solve program, from the harness's
CUDA events around each call."""

from vio_bench.metrics._spans import total_ms


def read(run):
    got = total_ms(run, ("solve",))
    return got[0] / got[1] if got and got[1] else None
