"""The fused LK kernel's share of its bytes bound over the traced slice: the
mean least time of a launch (``roofline.lk_bound_s`` at the slots the frame
tracked) over the mean device time of its executions in the slice."""

from vio_bench import roofline

KERNEL = "lk_pyramid_kernel"


def read(run):
    sl = run["window"].get("slice") or {}
    names = [k for k in sl.get("by_name", {}) if KERNEL in k]
    n = sum(sl["count"][k] for k in names) if names else 0
    if not n or not sl.get("n_valid"):
        return None
    t = sum(sl["by_name"][k] for k in names) / n
    slots = run["cfg"]["n_slots"]
    bound = sum(roofline.lk_bound_s(run["shapes"], slots, v) for v in sl["n_valid"])
    return 100.0 * bound / len(sl["n_valid"]) / t
