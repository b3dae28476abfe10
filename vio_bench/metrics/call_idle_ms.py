"""Card idle time a frame of the traced slice charged to the device
programs' calls (``device.py``: the copies into a graph's static inputs,
the replay's launch, a capture): the idle gaps whose midpoint lies in a
``vio::prog.*`` span of the port, innermost (``trace.summarize``'s
``idle_by_host``), in ms over the slice's frames; 0.0 where none did."""

PREFIX = "vio::prog."


def read(run):
    sl = run["window"].get("slice") or {}
    if not sl.get("frames"):
        return None
    idle = sl.get("idle_by_host") or {}
    return 1e3 * sum(v for k, v in idle.items() if k.startswith(PREFIX)) / sl["frames"]
