"""The float32 marginalization QR on the stacks of bench.py's streams, on one
CUDA card: how far ``marg_qr``, its plain version and ``torch.linalg.qr``
each land from float64 arithmetic on the same float32 stack, in the kept
information (the prior) that ``chip_smoke.py``'s ``[14m]`` check bounds by
``MARG_KEPT_BOUNDS``.

    python3 marg_f32_spread.py [EARLIER_MARG_QR_CU]     (beside chip_smoke.py)

Runs bench.py's default and high-rate workloads whole through a synchronous
pipeline (lag 1, depth 1) with the estimator's programs eager
(``use_graphs`` off, so every call goes through Python) and records every
stack ``marg_qr`` is given: MARGIN_OLD's (its head shorter than the stack;
15 dropped columns) and SECOND_NEW's (the stack all head; 6). For each, the
kept information (``chip_smoke.kept_error``) of ``marg_qr``, ``qr_plain``
and ``torch.linalg.qr`` in float32 against ``qr_plain`` in float64 on the
stack upcast, and of ``marg_qr`` with the whole stack as its head ("one
leaf": no tree, no merge; the same panels and skip rule). Prints the card's
line, a line a stack, the largest reading of each QR, and how many stacks
put ``marg_qr`` (and its one leaf) above 1.5 times the worse of the plain
version and ``torch.linalg.qr`` (the plain version takes the same skip rule
without tiles, panels or tree; the library takes none). Each reading also
without the kept information's (r, r) entry (JᵀJ and Jᵀr alone): where the
kept information is singular (the first marginalization, no prior) that
entry, the part of the residual's norm in the kept rows, is set by
rounding-level pivots. With EARLIER_MARG_QR_CU (for example the first design's source
from ``git show affed1d:lfvio_tpu_torch/csrc/marg_qr.cu``), that source's
``marg_qr`` too ("earlier marg_qr", built as ``turns.py marg`` builds it).
"""

import sys


def record_stacks(dev, knobs):
    """[(stack, head, dropped columns)] of every marg_qr call of a
    workload's whole stream."""
    import torch

    import chip_smoke
    from lfvio_tpu_torch import bench
    from lfvio_tpu_torch.backend import marg_cuda as mc
    from lfvio_tpu_torch.backend import marginalize as mg

    stacks = []

    def recording(A, head=0):
        stacks.append((A.clone(), head, 15 if head < A.shape[0] else 6))
        return mc.marg_qr(A, head=head)

    wl = bench.workload(bench.config_from_env(knobs), dev)
    _, est, pipe = wl.make(1, 1)
    est.use_graphs = False
    mg.marg_qr = recording
    try:
        for it in wl.stream:
            bench.feed(pipe, [it], wl.frames)
        pipe.flush()
        torch.cuda.synchronize()
    finally:
        mg.marg_qr = mc.marg_qr
    chip_smoke.log(f"{knobs or 'default'}: {len(est.times)} solves, {len(stacks)} stacks")
    return stacks


def main(argv):
    import torch

    import chip_smoke
    from lfvio_tpu_torch.backend import marg_cuda as mc

    if len(argv) > 1:
        print(f"usage: {sys.argv[0]} [EARLIER_MARG_QR_CU]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("marg_f32_spread.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi_line(), flush=True)
    earlier = None
    if argv:
        from pathlib import Path

        import turns

        earlier = turns.bind_marg_qr(turns.build_earlier_lib(Path(argv[0]), "marg_qr"))
    worst, worst_no_rr, n = {}, {}, 0
    above = {k: 0 for k in ("marg_qr", "marg_qr, one leaf", "earlier marg_qr")
             if k != "earlier marg_qr" or argv}
    for name, knobs in (("default", {}), ("high-rate", chip_smoke.BENCH_HIGH_RATE)):
        for i, (A, head, m) in enumerate(record_stacks(dev, knobs)):
            exact = mc.qr_plain(A.double())
            got = {"marg_qr": mc.marg_qr(A, head=head), "plain": mc.qr_plain(A),
                   "torch.linalg.qr": torch.linalg.qr(A, mode="r")[1],
                   "marg_qr, one leaf": mc.marg_qr(A, head=A.shape[0])}
            if earlier is not None:
                got["earlier marg_qr"] = earlier(A, head=head)
            errs = {k: chip_smoke.kept_error(A, R, exact, m) for k, R in got.items()}
            no_rr = {k: chip_smoke.kept_error(A, R, exact, m, with_rr=False)
                     for k, R in got.items()}
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
                worst_no_rr[k] = max(worst_no_rr.get(k, 0.0), no_rr[k])
            others = max(errs["plain"], errs["torch.linalg.qr"])
            flags = [k for k in above if errs[k] > 1.5 * others]
            for k in flags:
                above[k] += 1
            n += 1
            print(f"{name} stack {i} {tuple(A.shape)} head {head} dropped {m}: kept information "
                  "against f64 arithmetic " + ", ".join(
                      f"{k} {v:.3e} ({no_rr[k]:.3e} without (r, r))" for k, v in errs.items())
                  + (f"; above 1.5x the worse of the others: {', '.join(flags)}" if flags else ""),
                  flush=True)
    print("largest: " + ", ".join(f"{k} {v:.3e} ({worst_no_rr[k]:.3e} without (r, r))"
                                  for k, v in worst.items()), flush=True)
    print(f"stacks above 1.5x the worse of the plain version and torch.linalg.qr, of {n}: "
          + ", ".join(f"{k} {v}" for k, v in above.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
