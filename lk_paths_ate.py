"""The full-scale stream through each LK path, on one CUDA card: does the
trajectory depend on the path, and do the paths agree on the real frames?

    python3 lk_paths_ate.py      (beside chip_smoke.py, whose rig it uses)

The paths: the fused launch (one per frame), the level loop on the host over
the one-level wrapper (five launches per frame), and the plain version.
First the FrontEnd alone runs ``chip_smoke.py``'s full-scale stream
(1280x960, 256 slots, 90 frames) on the fused launch while the five-launch
path and the plain version get the same inputs on every tracked frame; the
count of ``ok`` flags that differ and the largest position difference are
printed. Then the whole pipeline runs the stream once on each path (fused,
five launches, plain, fused again) at solve lag 1 / depth 1, and once more on
the fused launch at solve lag 2 / depth 3 (bench.py's own configuration), and
prints its solves, the time of its first solve and its ATE.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke
from lfvio_tpu_torch.frontend import klt, klt_cuda


def main():
    if not torch.cuda.is_available():
        print("lk_paths_ate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi_line())
    world, stream, frames, make = chip_smoke.full_scale_rig(torch.device("cuda", 0))
    paths = {"fused": klt_cuda.lk_pyramid,
             "five launches": lambda *a, **k: klt.lk_pyramid(klt_cuda.lk_level, *a,
                                                             k["refine_win"]),
             "plain": klt.pyramidal_lk}

    rows = []

    def shadowed(*a, **k):
        out = {name: fn(*a, **k) for name, fn in paths.items()}
        (pp, pok) = out["plain"]
        rows.append([int(pok.sum())] + [
            v for name in ("fused", "five launches")
            for v in (int((out[name][1] != pok).sum()),
                      (out[name][0] - pp)[out[name][1] & pok].abs().max().item())])
        return out["fused"]

    # The FrontEnd, run op by op (use_graphs off: a graph holds the LK
    # launch it captured), looks its LK call up in klt_cuda at every frame.
    fe, _, _ = make()
    fe.use_graphs = False
    klt_cuda.pyramidal_lk = shadowed
    for i, t in enumerate(sorted(frames)):
        fe.process_arrays(frames[t], t, publish=i % 3 != 1)
    r = np.array(rows)
    print(f"{len(r)} tracked frames, {r[:, 0].mean():.1f} tracks ok on average (plain); against "
          f"plain: fused {int(r[:, 1].sum())} ok flags differ, max {r[:, 2].max():.3g} px; "
          f"five launches {int(r[:, 3].sum())} ok flags differ, max {r[:, 4].max():.3g} px",
          flush=True)

    for name, lag, depth in (("fused", 1, 1), ("five launches", 1, 1), ("plain", 1, 1),
                             ("fused", 1, 1), ("fused", 2, 3)):
        fe, est, pipe = make(lag, depth)
        fe.use_graphs = False
        klt_cuda.pyramidal_lk = paths[name]
        chip_smoke.bench.feed(pipe, stream, frames)
        pipe.flush()
        ate, n = chip_smoke.trajectory_ate(world, est)
        print(f"{name}, solve lag {lag}, depth {depth}: {len(est.times)} solves, first at t = {est.times[0]:.4f} s, "
              f"ATE {ate:.5f} m over {n} poses", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
