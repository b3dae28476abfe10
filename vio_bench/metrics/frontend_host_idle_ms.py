"""Card idle time a frame of the traced slice charged to the front end's
host code (``runtime/tracker.py``: a frame's dispatch, the image's upload,
RANSAC's draws, the wait for a frame's results and its bookkeeping): the
idle gaps whose midpoint lies in a ``vio::fe.*`` span of the port,
innermost (``trace.summarize``'s ``idle_by_host``), in ms over the slice's
frames; 0.0 where none did."""

PREFIX = "vio::fe."


def read(run):
    sl = run["window"].get("slice") or {}
    if not sl.get("frames"):
        return None
    idle = sl.get("idle_by_host") or {}
    return 1e3 * sum(v for k, v in idle.items() if k.startswith(PREFIX)) / sl["frames"]
