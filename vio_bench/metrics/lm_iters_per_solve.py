"""LM iterations run a solve over the window's finalized solves
(``Estimator.lm_runs``)."""


def read(run):
    runs = run["lm_runs"]
    return sum(r[0] for r in runs) / len(runs) if runs else None
