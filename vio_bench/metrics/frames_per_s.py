"""Frames handed to the pipeline in the window over the window's wall time,
from the first event to the end of the flush and the wait for the card."""


def read(run):
    w = run["window"]
    return w["frames"] / w["wall_s"] if w["wall_s"] > 0 else None
