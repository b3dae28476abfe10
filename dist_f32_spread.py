"""Phase 12's float32 gate of ``chip_smoke.py`` over several perturbation
seeds, on one CUDA card: how far the sharded frame step and the
single-device chain each land from the float64 result, and their ratio.

    python3 dist_f32_spread.py TREE SEED [SEED ...]     (beside chip_smoke.py)

TREE is a checkout of the repository (``.`` for this one) whose
``chip_smoke.dist_rank`` and port run the step; SEED replaces the seed (3)
of the state's perturbation in ``dist_rank``. For each seed: two ranks on
the card (gloo), float64 then float32, as phase 12 runs them; prints the
float32 states' and prior's distance to the float64 single-device result,
sharded and single-device, their ratio and whether phase 12's bound
(``DIST_F32_FACTOR`` times the single-device distance) holds.
"""

import os
import sys

TREE = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.getcwd()
sys.path.insert(0, TREE)
import numpy as np  # noqa: E402

_default_rng = np.random.default_rng


def rank(r, world, init, out, seed, dtype_name, device, n_slots):
    """One rank of chip_smoke.dist_rank with the perturbation's seed (3)
    replaced by ``seed``."""
    import chip_smoke

    np.random.default_rng = lambda s=None: _default_rng(seed if s == 3 else s)
    chip_smoke.dist_rank(r, world, init, out, dtype_name, device, n_slots)


def main(seeds):
    os.chdir(TREE)
    import chip_smoke
    from lfvio_tpu_torch.dist.scaling_bench import spawn_ranks

    print(chip_smoke.smi_line(), flush=True)
    rel = lambda a, b: float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    for seed in seeds:
        runs = {d: spawn_ranks(rank, 2, (seed, d, "cuda:0", 256))[0]
                for d in ("float64", "float32")}
        r64, r32 = runs["float64"], runs["float32"]
        errs = lambda tag: (max(rel(r32[tag + k], r64["ref_" + k]) for k in chip_smoke.DIST_STATES),
                            max(rel(r32[tag + k], r64["ref_" + k]) for k in ("H", "b")))
        sharded, single = errs(""), errs("ref_")
        holds = all(a <= max(chip_smoke.DIST_F32_FACTOR * b, 1e-4) for a, b in zip(sharded, single))
        print(f"{os.path.basename(TREE)} seed {seed}: states sharded {sharded[0]:.2e} single "
              f"{single[0]:.2e} (ratio {sharded[0] / single[0]:.2f}); prior sharded "
              f"{sharded[1]:.2e} single {single[1]:.2e} (ratio {sharded[1] / single[1]:.2f}); "
              f"bound {'holds' if holds else 'fails'}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(f"usage: {sys.argv[0]} TREE SEED [SEED ...]", file=sys.stderr)
        sys.exit(2)
    main([int(s) for s in sys.argv[2:]])
