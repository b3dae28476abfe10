"""Card idle time a frame of the traced slice charged to the estimator's
host code (``runtime/estimator.py`` and its feature manager: IMU, a frame's
features, a solve's packing, upload and prior copy, the wait for its
results and their write-back): the idle gaps whose midpoint lies in a
``vio::est.*`` span of the port, innermost (``trace.summarize``'s
``idle_by_host``), in ms over the slice's frames; 0.0 where none did."""

PREFIX = "vio::est."


def read(run):
    sl = run["window"].get("slice") or {}
    if not sl.get("frames"):
        return None
    idle = sl.get("idle_by_host") or {}
    return 1e3 * sum(v for k, v in idle.items() if k.startswith(PREFIX)) / sl["frames"]
