"""Card time a solve of the MARGIN_OLD and SECOND_NEW programs, from the
harness's CUDA events around each call."""

from vio_bench.metrics._spans import total_ms


def read(run):
    solves = total_ms(run, ("solve",))
    marg = total_ms(run, ("marg_old", "marg_new"))
    if not solves or not solves[1] or not marg[1]:
        return None
    return marg[0] / solves[1]
