"""Share of the traced slice in which no kernel, copy or fill ran on the card."""


def read(run):
    sl = run["window"].get("slice") or {}
    if not sl.get("window_s"):
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
