"""Peaks of the card and the bounds that per-layer roofline shares are read
against: the least time a kernel's work could take on the card.

The LK bound is a copy of the arithmetic of the repository's
``chip_smoke.lk_bound_ms`` (bytes part), so that it reads the same work
whatever implements the tracker."""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (dense, 700 W): HBM bandwidth and
# float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

LK_WIN = 41  # the pyramid passes' window
LK_REFINE_WIN = 15  # the level-0 refine pass's window


def level_shapes(height, width, n_levels=3):
    """(h, w) of each pyramid level, level 0 first (pyrDown rounds up)."""
    shapes = [(height, width)]
    for _ in range(n_levels):
        h, w = shapes[-1]
        shapes.append((-(-h // 2), -(-w // 2)))
    return shapes


def lk_bytes(shapes, n_slots, n_valid):
    """Bytes a fused LK launch must move for ``n_valid`` tracked features of
    ``n_slots``: each level image read once, or only the patches cut from it
    where those are smaller ((win+4)² floats of the previous frame's level,
    (win+13)² of the next one's; a level counts its largest pass), and every
    slot's point and flag in and out. The features that reach each pass are
    taken as all ``n_valid`` (an upper bound: the share read against it is
    one too)."""
    nbytes = n_slots * (8 + 1) * 2
    win = LK_WIN  # the refine pass's patches (win 15) lie inside level 0's
    for h, w in shapes:
        nbytes += min(4.0 * h * w, 4.0 * n_valid * (win + 4) ** 2)
        nbytes += min(4.0 * h * w, 4.0 * n_valid * (win + 13) ** 2)
    return nbytes


def lk_bound_s(shapes, n_slots, n_valid):
    """The least time of one LK launch, by bytes."""
    return lk_bytes(shapes, n_slots, n_valid) / PEAK_BYTES_S
