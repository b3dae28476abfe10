"""Card time of the device programs from the harness's CUDA-event spans
around their calls (traced runs)."""


def total_ms(run, names):
    """(sum of the spans of programs whose name is in ``names`` or starts
    with one ending in '_', their count), or None without spans."""
    spans = run.get("spans_ms")
    if spans is None:
        return None
    hit = [v for k, v in spans.items()
           if k in names or any(n.endswith("_") and k.startswith(n) for n in names)]
    return sum(sum(v) for v in hit), sum(len(v) for v in hit)
