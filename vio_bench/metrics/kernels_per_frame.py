"""Kernel executions on the card in the traced slice per frame handed over in it."""


def read(run):
    sl = run["window"].get("slice") or {}
    if not sl.get("frames") or not sl.get("kernels"):
        return None
    return sl["kernels"] / sl["frames"]
