#!/usr/bin/env python3
"""Two versions of the solver timed in turns on one CUDA card, within one
call (host-timed numbers move by up to 25% between calls, the solve
replay by up to 2.9 ms, so two versions are compared only inside one).

    python3 turns.py tree OTHER_TREE                 (beside chip_smoke.py)
    python3 turns.py proj EARLIER_PROJ_FACTOR_CU
    python3 turns.py imu EARLIER_IMU_FACTOR_CU
    python3 turns.py rows EARLIER_PROJ_FACTOR_CU
    python3 turns.py eig EARLIER_SYM_EIG_CU
    python3 turns.py relo EARLIER_PROJ_FACTOR_CU
    python3 turns.py marg EARLIER_MARG_QR_CU
    python3 turns.py depth OTHER_MARG_QR_CU

``tree``: OTHER_TREE is another checkout (for example ``git archive
<commit>`` unpacked under ``_archive/``, which ``.gitignore`` lists). In the
order OTHER, this, this, OTHER each tree runs, in processes of its own from
its own root (so each builds and imports its own package): its
``chip_smoke.program_census`` of the solve, MARGIN_OLD and SECOND_NEW graphs
of an estimator warmed up in bench.py's default configuration (a) and in
its high-rate one (b) (kernel nodes, conditional bodies' included, and the
card's ms per replay, CUDA events; where the tree's census has them, the LM
iterations and linearizations a solve replay ran and the replay with every
iteration forced to run), then ``python -m lfvio_tpu_torch.bench`` in (a) and (b)
(frames/s). Prints a line per run, the card's ``nvidia-smi`` line, and
last one JSON object with every run's numbers.

``proj``: the LM solve's projection linearization as this tree launches it
(one ``proj_normal`` launch) against the rows + assemble pair of an earlier
``csrc/proj_factor.cu`` (one with ``proj_rows_launch`` and
``proj_assemble_launch``). Builds the given source with this tree's nvcc
flags into a library of its own, warms up an estimator in (a) and in (b)
(``chip_smoke.warm_estimator``), and at each one's next solve inputs (f32)
times, behind a full queue (``chip_smoke.cuda_ms`` with its blocker), the
pair (a rows launch, then an assemble launch over its rows, every output
allocated per call as the earlier wrappers did) and ``proj_normal``, in
turns pair, normal, normal, pair; then each launched alone. Both are held
against the plain version within ``chip_smoke.PROJ_BOUNDS`` of each
output's scale first. Prints the card's line, one line a time and one JSON
line of all of them last.

``imu``: the three launches of an earlier ``csrc/imu_factor.cu`` (one with
the same ``imu_rows_launch`` and ``imu_normal_launch``) against this
tree's. Builds the given source with this tree's nvcc flags into a library
of its own and binds it behind ``imu_cuda``'s wrapper classes (the same
checks, allocations and ctypes path), warms up an estimator in (a) and in
(b), holds both sources against the plain version at each one's next solve
inputs (f32), also with the biases moved (``chip_smoke.moved_biases``),
within ``chip_smoke.IMU_BOUNDS`` of each output's scale and with a repeat
bit-identical, then times ``imu_normal``, ``imu_cost`` and ``imu_rows``
behind a full queue in turns earlier, this, this, earlier, and each
launched alone. Prints as ``proj`` does.

``rows``: the rows and cost launches of an earlier ``csrc/proj_factor.cu``
(one with the same ``proj_rows_launch``) against this tree's, as ``imu``
does for its three: the earlier source behind ``proj_cuda``'s wrapper
class, both held against the plain version at (a) and (b) within
``chip_smoke.PROJ_BOUNDS`` with a repeat bit-identical, then ``proj_rows``
and ``proj_cost`` timed in turns at (a) and (b), beside this tree's latency
floor of each launch (``proj_cuda.latency_floor``).

``eig``: an earlier ``csrc/sym_eig.cu`` (one with the same
``sym_eig_launch``) behind ``eigh_cuda``'s wrapper class against this
tree's: both held against ``torch.linalg.eigh`` within
``chip_smoke.EIG_BOUNDS`` at the main path's inputs at 256 and 384 slots
(``chip_smoke.main_path_eig_inputs``) in f32 and f64, with each one's
sweep histogram and a repeat bit-identical, then each of the five inputs
at 256 slots and the [384, 4, 4] triangulation timed in turns, beside
this tree's latency floor of the launch (``eigh_cuda.latency_floor``).

``relo``: the relocalization launches of an earlier ``csrc/proj_factor.cu``
(one with the same ``relo_launch``) behind ``relo_cuda``'s wrapper class
against this tree's: runs ``chip_smoke.phase_relo_full_scale`` (phase 6r)
for its relo inputs, holds both sources against the plain version within
``chip_smoke.RELO_BOUNDS`` with a repeat bit-identical at those inputs, on
``relo_window``'s two-camera window (f64 and f32, extrinsics estimated)
and on ``relo_layout``'s f32 windows of 21 frames and 384 slots (the
high-rate configuration's width: anchors 96% at frame 0 or spread, one
camera or two with the extrinsics estimated), then times ``relo_normal``
and ``relo_cost`` behind a full queue in turns earlier, this, this,
earlier at each f32 input, beside each source's latency floor of the
launch (its empty kernel with the launch's grid, block and shared memory).

``marg``: an earlier ``csrc/marg_qr.cu`` (one with the same
``marg_qr_launch`` and ``marg_qr_limits``) behind ``marg_cuda``'s wrapper
class against this tree's ``marg_qr``: on ``chip_smoke.marg_stacks``' f32
stacks ((a) and (b)'s MARGIN_OLD, (b)'s SECOND_NEW) both are held against
the plain version (RᵀR against AᵀA within ``chip_smoke.MARG_BOUNDS``, the
structure, the kept information against the plain version in f64 within
``chip_smoke.MARG_KEPT_BOUNDS``, a repeat bit-identical), then timed behind
a full queue in turns earlier, this, this, earlier, each beside its own
latency floor (its empty kernel with the launch's grid, block and shared
memory), the bound (``chip_smoke.marg_bound_ms``) and ``torch.linalg.qr``
of the same stack.

``depth``: another ``csrc/marg_qr.cu``'s ``marg_depth_launch`` (the same
arguments; an earlier source, or a variant of this one copied under
``_archive/``) behind ``marg_cuda``'s wrapper class against this tree's
``marg_depth``: at (a) and (b)'s MARGIN_OLD inputs (f32,
``chip_smoke.depth_inputs``) both are held against ``depth_plain`` within
``chip_smoke.MARG_BOUNDS`` with a repeat bit-identical (each also read
against ``depth_plain`` in float64 on the inputs upcast, beside
``depth_plain``'s own float32 reading), written into the
MARGIN_OLD stack's view after its head (as the program writes it) and into
a tensor of its own; then timed behind a full queue in turns (other, this,
this, other; each labelled by its file name), on the view and on the
tensor of its own, each launched alone too, beside each source's latency
floor, the bound (``chip_smoke.marg_bound_ms``) and its share of it.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

CENSUS = r"""
import json, torch
import chip_smoke as c
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
out = {}
for key, knobs in (("a", {}), ("b", c.BENCH_HIGH_RATE)):
    cen = c.program_census(c.warm_estimator(dev, knobs), f"({key})", trace=False)
    out[key] = dict(ms=cen["ms"], ran=cen.get("ran"), nodes=cen["nodes"],
                    kernel_nodes={k: v.get("kernel", 0) + v.get("body kernel", 0)
                                  for k, v in cen["nodes"].items()})
print("TURNS " + json.dumps(out))
"""
HIGH_RATE = {"LFVIO_BENCH_FRAME_RATE": "30", "LFVIO_BENCH_MAX_CNT": "300",
             "LFVIO_BENCH_WINDOW": "20", "LFVIO_BENCH_SLOTS": "384"}
TIMEOUT_S = 600


def run(tree, args, env=None):
    """stdout of ``python args`` run from ``tree``'s root; raises on failure."""
    res = subprocess.run([sys.executable, *args], cwd=tree, capture_output=True, text=True,
                         env={**os.environ, **(env or {})}, timeout=TIMEOUT_S)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: {args[:2]} exited {res.returncode}:\n{res.stderr[-4000:]}")
    return res.stdout


def one_turn(tree):
    """The census and the bench's frames/s of one tree, {...}."""
    out = run(tree, ["-c", CENSUS])
    rec = json.loads(out.split("TURNS ", 1)[1].splitlines()[0])
    for key, knobs in (("a", {}), ("b", HIGH_RATE)):
        line = run(tree, ["-m", "lfvio_tpu_torch.bench"], knobs).strip().splitlines()[-1]
        rec[key]["frames_per_s"] = json.loads(line)["value"]
    return rec


def tree_main(argv):
    """``tree OTHER_TREE``: the two trees' census and bench in turns."""
    if len(argv) != 1 or not os.path.exists(os.path.join(argv[0], "chip_smoke.py")):
        print(f"usage: {sys.argv[0]} tree OTHER_TREE (a checkout holding chip_smoke.py)",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(argv[0])
    runs = []
    for name, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        rec = one_turn(tree)
        runs.append(dict(tree=name, **rec))
        print(f"[turns] {name}: " + "; ".join(
            f"({k}) solve {rec[k]['ms']['solve']:.3f} ms"
            + (f" (LM iterations, linearizations run {rec[k]['ran']['solve']}), with every "
               f"iteration forced {rec[k]['ms']['solve_forced']:.3f} ms "
               f"({rec[k]['ran']['solve_forced']})" if rec[k].get("ran") else "")
            + f", marg_old {rec[k]['ms']['marg_old']:.3f} "
            f"ms, solve kernel nodes {rec[k]['kernel_nodes']['solve']}, marg_old nodes "
            f"{rec[k]['kernel_nodes']['marg_old']}, {rec[k]['frames_per_s']:.3f} frames/s"
            for k in ("a", "b")), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"other": other, "runs": runs}))
    return 0


def build_earlier_lib(src, stem, tag="earlier"):
    """The earlier source built with this tree's nvcc flags into a library
    of its own, loaded."""
    from lfvio_tpu_torch.frontend import klt_cuda

    lib = klt_cuda.BUILD_DIR / f"lib{stem}_{tag}.so"
    klt_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([klt_cuda.nvcc_path(), *klt_cuda.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True)
    return ctypes.CDLL(str(lib))


def build_earlier(src):
    """The earlier source built into a library of its own; its two
    launchers, bound."""
    so = build_earlier_lib(src, "proj_factor")
    P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    rows, asm = so.proj_rows_launch, so.proj_assemble_launch
    rows.argtypes = [P] * 13 + [I, I, I, Dbl, Dbl, I, I, P, P, P, P, P]
    asm.argtypes = [P] * 7 + [I] * 6 + [P] * 6
    rows.restype = asm.restype = I
    return rows, asm


def pair_fn(rows_launch, asm_launch, state, grid, cfg):
    """One linearization through the earlier pair: (H_pp, H_pl, H_ll, b_p,
    b_l, cost terms)."""
    import torch
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend.state import pose_dim

    dtype, dev, C, F, W1, ptrs = pc._state_inputs("pair", state, grid)
    D = pose_dim(W1, C)
    stream = torch.cuda.current_stream(dev).cuda_stream
    new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    dt = pc._DTYPES[dtype]

    def run():
        res, J26, w, cost = new(F, W1, 2), new(F, W1, 2, 26), new(F, W1), new(F, W1)
        err = rows_launch(*ptrs, F, W1, C, float(cfg.proj_sqrt_info), float(cfg.cauchy_c), 1,
                          dt, res.data_ptr(), J26.data_ptr(), w.data_ptr(), cost.data_ptr(),
                          stream)
        H_pp, b_p, H_pl, H_ll, b_l = new(D, D), new(D), new(D, F), new(F), new(F)
        err = err or asm_launch(res.data_ptr(), J26.data_ptr(), w.data_ptr(), *ptrs[9:13], F,
                                W1, C, int(cfg.estimate_extrinsic), int(cfg.estimate_td), dt,
                                H_pp.data_ptr(), b_p.data_ptr(), H_pl.data_ptr(),
                                H_ll.data_ptr(), b_l.data_ptr(), stream)
        if err:
            raise RuntimeError(f"the earlier pair's launch failed: cudaError {err}")
        return H_pp, H_pl, H_ll, b_p, b_l, cost

    return run


def proj_main(argv):
    """``proj EARLIER_PROJ_FACTOR_CU``: the earlier pair against ``proj_normal`` in turns."""
    import torch

    import chip_smoke
    from lfvio_tpu_torch.backend import proj_cuda as pc
    from lfvio_tpu_torch.backend.state import n_cams_of

    if not torch.cuda.is_available():
        print("turns.py proj: no CUDA device", file=sys.stderr)
        return 2
    if len(argv) != 1:
        print(f"usage: {sys.argv[0]} proj EARLIER_PROJ_FACTOR_CU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    rows_launch, asm_launch = build_earlier(Path(argv[0]))
    names = ("H_pp", "H_pl", "H_ll", "b_p", "b_l", "normal cost terms")
    block = chip_smoke.make_blocker(dev)
    out = {}
    for label, knobs in (("a", {}), ("b", chip_smoke.BENCH_HIGH_RATE)):
        state, grid, cfg = chip_smoke.solve_inputs(chip_smoke.warm_estimator(dev, knobs))
        C = n_cams_of(state)
        F, W1 = grid.valid.shape
        anchors = torch.bincount(grid.anchor[grid.used & (grid.anchor >= 0)], minlength=W1)
        print(f"({label}) {F} slots, {W1} frames, {int(grid.used.sum())} used; used features by "
              f"anchor frame {anchors.tolist()}", flush=True)
        pair = pair_fn(rows_launch, asm_launch, state, grid, cfg)
        normal = lambda: pc.proj_normal(state, grid, cfg, C)
        plain = chip_smoke.proj_outputs(state, grid, cfg, plain=True)
        scale = chip_smoke.proj_scales(state, grid, cfg, plain)
        bound = chip_smoke.PROJ_BOUNDS["float32"]
        for who, fn in (("pair", pair), ("proj_normal", normal)):
            errs = {n: float((x - plain[n]).abs().max()) / scale[n] for n, x in zip(names, fn())}
            print(f"({label}) {who} against the plain version, relative to each output's scale: "
                  + ", ".join(f"{n} {v:.2e}" for n, v in errs.items()), flush=True)
            if max(errs.values()) > bound:
                raise AssertionError(f"({label}) {who} is not within {bound} of the plain version")
        turns = []
        for who, fn in (("pair", pair), ("proj_normal", normal), ("proj_normal", normal),
                        ("pair", pair)):
            turns.append((who, chip_smoke.cuda_ms(fn, reps=10, blocker=block)))
            print(f"({label}) {who}: {turns[-1][1]:.4f} ms behind a full queue", flush=True)
        alone = {who: chip_smoke.cuda_ms(fn) for who, fn in (("pair", pair),
                                                              ("proj_normal", normal))}
        print(f"({label}) launched alone: pair {alone['pair']:.4f} ms, proj_normal "
              f"{alone['proj_normal']:.4f} ms", flush=True)
        out[label] = dict(turns=turns, alone=alone, slots=F, frames=W1)
    print(json.dumps({"card": smi, "times_ms": out}))
    return 0


def build_earlier_imu(src):
    """The earlier IMU source built into a library of its own, behind
    ``imu_cuda``'s wrapper classes: {"imu_rows", "imu_cost", "imu_normal":
    wrapper}."""
    from lfvio_tpu_torch.backend import imu_cuda as ic

    so = build_earlier_lib(src, "imu_factor")
    rows, normal = so.imu_rows_launch, so.imu_normal_launch
    rows.argtypes = normal.argtypes = [ic._P] * ic._N_IN + [ic._I] * 3 + [ic._P] * 4
    rows.restype = normal.restype = ctypes.c_int
    kernels = {"imu_rows": ic.ImuRowsKernel(cost_only=False),
               "imu_cost": ic.ImuRowsKernel(cost_only=True), "imu_normal": ic.ImuNormalKernel()}
    kernels["imu_rows"]._fn = kernels["imu_cost"]._fn = rows
    kernels["imu_normal"]._fn = normal
    return kernels


def imu_main(argv):
    """``imu EARLIER_IMU_FACTOR_CU``: the earlier source's launches against
    this tree's in turns."""
    import torch

    import chip_smoke
    from lfvio_tpu_torch.backend import imu_cuda as ic
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    if not torch.cuda.is_available():
        print("turns.py imu: no CUDA device", file=sys.stderr)
        return 2
    if len(argv) != 1:
        print(f"usage: {sys.argv[0]} imu EARLIER_IMU_FACTOR_CU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    sources = {"earlier": build_earlier_imu(Path(argv[0])),
               "this": {"imu_rows": ic.imu_rows, "imu_cost": ic.imu_cost,
                        "imu_normal": ic.imu_normal}}
    block = chip_smoke.make_blocker(dev)
    bound = chip_smoke.IMU_BOUNDS["float32"]
    out = {}
    for label, knobs in (("a", {}), ("b", chip_smoke.BENCH_HIGH_RATE)):
        args = chip_smoke.imu_solve_inputs(chip_smoke.warm_estimator(dev, knobs))
        W1 = args[0].p.shape[0]
        for who, kernels in sources.items():
            for case, a in (("", args), (", biases moved", chip_smoke.moved_biases(args))):
                errs, _, identical = chip_smoke.imu_compare(a, kernels=kernels)
                print(f"({label}{case}) {who} against the plain version, relative to each "
                      f"output's scale: " + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
                      + f"; repeat bit-identical {identical}", flush=True)
                if not (identical and max(errs.values()) <= bound):
                    raise AssertionError(f"({label}{case}) {who} is not within {bound} of the "
                                         "plain version, or a repeat differs")
        D = pose_dim(W1, n_cams_of(args[0]))
        H = torch.zeros((D, D), dtype=args[0].p.dtype, device=dev)
        b = torch.zeros(D, dtype=args[0].p.dtype, device=dev)
        calls = {who: {"imu_normal": lambda k=k: k["imu_normal"](H, b, *args),
                       "imu_cost": lambda k=k: k["imu_cost"](*args),
                       "imu_rows": lambda k=k: k["imu_rows"](*args)}
                 for who, k in sources.items()}
        out[label] = dict(frames=W1)
        for name in ("imu_normal", "imu_cost", "imu_rows"):
            turns = []
            for who in ("earlier", "this", "this", "earlier"):
                turns.append((who, chip_smoke.cuda_ms(calls[who][name], reps=10, blocker=block)))
                print(f"({label}) {name}, {who}: {turns[-1][1]:.4f} ms behind a full queue",
                      flush=True)
            alone = {who: chip_smoke.cuda_ms(calls[who][name]) for who in sources}
            print(f"({label}) {name} launched alone: earlier {alone['earlier']:.4f} ms, this "
                  f"{alone['this']:.4f} ms", flush=True)
            out[label][name] = dict(turns=turns, alone=alone)
    print(json.dumps({"card": smi, "times_ms": out}))
    return 0


def in_turns(label, name, calls, block):
    """``calls`` {"earlier", "this": callable} timed behind a full queue in
    turns earlier, this, this, earlier, then each launched alone; printed,
    and returned as {"turns": [(who, ms)], "alone": {who: ms}}."""
    import chip_smoke

    turns = []
    for who in ("earlier", "this", "this", "earlier"):
        turns.append((who, chip_smoke.cuda_ms(calls[who], reps=10, blocker=block)))
        print(f"({label}) {name}, {who}: {turns[-1][1]:.4f} ms behind a full queue", flush=True)
    alone = {who: chip_smoke.cuda_ms(fn) for who, fn in calls.items()}
    print(f"({label}) {name} launched alone: earlier {alone['earlier']:.4f} ms, this "
          f"{alone['this']:.4f} ms", flush=True)
    return dict(turns=turns, alone=alone)


def floor_ms(label, name, fn, block):
    """This tree's latency floor of a launch: ``fn`` launches its empty
    kernel; behind a full queue and alone, printed; {"queued", "alone"}."""
    import chip_smoke

    out = dict(queued=chip_smoke.cuda_ms(fn, reps=10, blocker=block),
               alone=chip_smoke.cuda_ms(fn))
    print(f"({label}) {name}, latency floor of this tree's launch (its empty kernel): "
          f"{out['queued']:.4f} ms behind a full queue, {out['alone']:.4f} ms alone", flush=True)
    return out


def card_or_usage(mode, argv, what):
    """The card, or None after printing why not (no card, wrong arguments)."""
    import torch

    if not torch.cuda.is_available():
        print(f"turns.py {mode}: no CUDA device", file=sys.stderr)
        return None
    if len(argv) != 1:
        print(f"usage: {sys.argv[0]} {mode} {what}", file=sys.stderr)
        return None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def rows_main(argv):
    """``rows EARLIER_PROJ_FACTOR_CU``: the earlier source's rows and cost
    launches against this tree's in turns."""
    import chip_smoke
    from lfvio_tpu_torch.backend import proj_cuda as pc

    dev = card_or_usage("rows", argv, "EARLIER_PROJ_FACTOR_CU")
    if dev is None:
        return 2
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    earlier_fn = build_earlier_lib(Path(argv[0]), "proj_factor").proj_rows_launch
    earlier_fn.argtypes, earlier_fn.restype = pc._ROWS_ARGTYPES, ctypes.c_int
    earlier = {"proj_rows": pc.ProjRowsKernel(cost_only=False),
               "proj_cost": pc.ProjRowsKernel(cost_only=True)}
    for k in earlier.values():
        k._fn = earlier_fn
    sources = {"earlier": earlier, "this": {"proj_rows": pc.proj_rows, "proj_cost": pc.proj_cost}}
    block = chip_smoke.make_blocker(dev)
    bound = chip_smoke.PROJ_BOUNDS["float32"]
    out = {}
    for label, knobs in (("a", {}), ("b", chip_smoke.BENCH_HIGH_RATE)):
        state, grid, cfg = chip_smoke.solve_inputs(chip_smoke.warm_estimator(dev, knobs))
        for who, kernels in sources.items():
            errs, _, identical = chip_smoke.proj_compare(state, grid, cfg, kernels=kernels)
            print(f"({label}) {who} against the plain version, relative to each output's "
                  f"scale: " + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
                  + f"; repeat bit-identical {identical}", flush=True)
            if not (identical and max(errs.values()) <= bound):
                raise AssertionError(f"({label}) {who} is not within {bound} of the plain "
                                     "version, or a repeat differs")
        out[label] = dict(slots=grid.valid.shape[0], frames=grid.valid.shape[1])
        for name in ("proj_rows", "proj_cost"):
            calls = {who: lambda k=k: k[name](state, grid, cfg) for who, k in sources.items()}
            out[label][name] = in_turns(label, name, calls, block)
            out[label][name]["floor"] = floor_ms(
                label, name, lambda: pc.latency_floor(name, state, grid, cfg), block)
    print(json.dumps({"card": smi, "times_ms": out}))
    return 0


def eig_main(argv):
    """``eig EARLIER_SYM_EIG_CU``: the earlier source's eigensolver against
    this tree's in turns."""
    import numpy as np
    import torch

    import chip_smoke
    from lfvio_tpu_torch.geom import eigh_cuda

    dev = card_or_usage("eig", argv, "EARLIER_SYM_EIG_CU")
    if dev is None:
        return 2
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    earlier = eigh_cuda.SymEigKernel()
    earlier._fn = build_earlier_lib(Path(argv[0]), "sym_eig").sym_eig_launch
    earlier._fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    earlier._fn.restype = ctypes.c_int
    sources = {"earlier": earlier, "this": eigh_cuda.sym_eig}
    inputs = {256: chip_smoke.main_path_eig_inputs(dev), 384: chip_smoke.main_path_eig_inputs(
        dev, 384)}
    for dtype in (torch.float32, torch.float64):
        ew_b, er_b, ev_b, gap = chip_smoke.EIG_BOUNDS[str(dtype).split(".")[-1]]
        for slots, seen in inputs.items():
            for A in seen:
                A = A.to(dtype)
                w_ref, V_ref = torch.linalg.eigh(A)
                for who, eig in sources.items():
                    w, V, sweeps = eig(A, sweeps=True)
                    again = eig(A, sweeps=True)
                    identical = all(torch.equal(x, y) for x, y in zip((w, V, sweeps), again))
                    ew, er, ev, share = chip_smoke.eig_errors(A, w, V, w_ref, V_ref, gap)
                    counts = sweeps.reshape(-1).cpu().numpy()
                    hist = dict(zip(*np.unique(counts, return_counts=True)))
                    print(f"{who} {dtype} {tuple(A.shape)} ({slots} slots): eigenvalues "
                          f"{ew:.2e}, residuals {er:.2e}, smallest eigenvector {ev:.2e} on the "
                          f"{100 * share:.0f}% well posed (bounds {ew_b}, {er_b}, {ev_b}); "
                          f"repeat bit-identical {identical}; sweeps "
                          + ", ".join(f"{int(k)}: {int(v)}" for k, v in sorted(hist.items())),
                          flush=True)
                    if not (identical and ew <= ew_b and er <= er_b and ev <= ev_b):
                        raise AssertionError(f"{who} disagrees with torch.linalg.eigh at "
                                             f"{tuple(A.shape)} {dtype}, or a repeat differs")
    block = chip_smoke.make_blocker(dev)
    out = {}
    for A in inputs[256] + inputs[384][:1]:
        label = "x".join(map(str, A.shape))
        calls = {who: lambda eig=eig: eig(A) for who, eig in sources.items()}
        out[label] = in_turns(label, "sym_eig", calls, block)
        out[label]["floor"] = floor_ms(label, "sym_eig", lambda: eigh_cuda.latency_floor(A),
                                       block)
    print(json.dumps({"card": smi, "times_ms": out}))
    return 0


def relo_main(argv):
    """``relo EARLIER_PROJ_FACTOR_CU``: the earlier source's relocalization
    launches against this tree's in turns."""
    import torch

    import chip_smoke
    from lfvio_tpu_torch.backend import relo_cuda as rc
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim

    dev = card_or_usage("relo", argv, "EARLIER_PROJ_FACTOR_CU")
    if dev is None:
        return 2
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    earlier_fn = build_earlier_lib(Path(argv[0]), "proj_factor").relo_launch
    earlier_fn.argtypes, earlier_fn.restype = rc._ARGTYPES, ctypes.c_int
    earlier = {"relo_normal": rc.ReloKernel(normal=True), "relo_cost": rc.ReloKernel(normal=False)}
    for k in earlier.values():
        k._fn = earlier_fn
    sources = {"earlier": earlier, "this": {"relo_normal": rc.relo_normal,
                                            "relo_cost": rc.relo_cost}}
    relo6 = chip_smoke.phase_relo_full_scale(chip_smoke.full_scale_rig(dev),
                                             chip_smoke.count_plain_lk())
    label_r = "(r) phase 6r's relo inputs, 256 slots, window 10, f32"
    label_2 = "two-camera 64 slots, f32, extrinsics estimated"
    cases = {label_r: relo6["args"], label_2: chip_smoke.relo_window(dev, torch.float32, 2),
             "two-camera 64 slots, f64, extrinsics estimated":
                 chip_smoke.relo_window(dev, torch.float64, 2)}
    for layout in chip_smoke.RELO_LAYOUTS:
        for C in (1, 2):
            cases[f"21 frames, 384 slots, {layout}, {C} camera(s), f32"] = chip_smoke.relo_layout(
                dev, torch.float32, 21, 384, C, layout)
    for label, args in cases.items():
        bound = chip_smoke.RELO_BOUNDS[str(args[0].p.dtype).split(".")[-1]]
        for who, kernels in sources.items():
            errs, _, identical = chip_smoke.relo_compare(args, kernels=kernels)
            print(f"{label}: {who} against the plain version, relative to each output's scale: "
                  + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
                  + f"; repeat bit-identical {identical}", flush=True)
            if not (identical and max(errs.values()) <= bound):
                raise AssertionError(f"{label}: {who} is not within {bound} of the plain "
                                     "version, or a repeat differs")
    block = chip_smoke.make_blocker(dev)
    out = {}
    for label in (k for k, args in cases.items() if args[0].p.dtype == torch.float32):
        state, grid, cfg, relo = cases[label]
        F, W1 = grid.valid.shape
        D6 = pose_dim(W1, n_cams_of(state)) + 6
        z = lambda *s: torch.zeros(s, dtype=state.p.dtype, device=dev)
        sums = (z(D6, D6), z(D6, F), z(F), z(D6), z(F))
        out[label] = {}
        for name in ("relo_normal", "relo_cost"):
            normal = name == "relo_normal"
            calls = {who: (lambda k=k: k[name](*sums, state, grid, *relo, cfg)) if normal else
                     (lambda k=k: k[name](state, grid, *relo, cfg)) for who, k in sources.items()}
            out[label][name] = in_turns(label, name, calls, block)
            out[label][name]["floor"] = floor_ms(
                label, name, lambda: rc.latency_floor(name, state, grid, *relo, cfg), block)
            empty = lambda: rc._launch(earlier_fn, name, int(normal), True, state, grid, relo, cfg,
                                       sums)
            fl = dict(queued=chip_smoke.cuda_ms(empty, reps=10, blocker=block),
                      alone=chip_smoke.cuda_ms(empty))
            print(f"({label}) {name}, latency floor of the earlier source's launch: "
                  f"{fl['queued']:.4f} ms behind a full queue, {fl['alone']:.4f} ms alone",
                  flush=True)
            out[label][name]["earlier_floor"] = fl
    print(json.dumps({"card": smi, "times_ms": out}))
    return 0


def bind_marg_qr(so):
    """A built ``csrc/marg_qr.cu``'s ``marg_qr_launch`` and
    ``marg_qr_limits`` behind ``marg_cuda``'s wrapper class."""
    from lfvio_tpu_torch.backend import marg_cuda as mc

    kernel = mc.MargQrKernel()
    kernel._fn, kernel._limits_fn = so.marg_qr_launch, so.marg_qr_limits
    kernel._fn.argtypes, kernel._fn.restype = mc._QR_ARGTYPES, ctypes.c_int
    kernel._limits_fn.argtypes, kernel._limits_fn.restype = mc._LIMITS_ARGTYPES, ctypes.c_int
    return kernel


def marg_main(argv):
    """``marg EARLIER_MARG_QR_CU``: the earlier source's marg_qr against
    this tree's in turns."""
    import torch

    import chip_smoke
    from lfvio_tpu_torch.backend import marg_cuda as mc

    dev = card_or_usage("marg", argv, "EARLIER_MARG_QR_CU")
    if dev is None:
        return 2
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    earlier = bind_marg_qr(build_earlier_lib(Path(argv[0]), "marg_qr"))
    sources = {"earlier": earlier, "this": mc.marg_qr}
    stacks = chip_smoke.marg_stacks(dev)
    for label, (A, head, m) in stacks.items():
        exact = mc.qr_plain(A.double())
        for who, kernel in sources.items():
            R, again = kernel(A, head=head), kernel(A, head=head)
            errs = {chip_smoke.MARG_RTR: chip_smoke.rtr_error(A, R),
                    chip_smoke.MARG_STRUCTURE: chip_smoke.qr_structure(R),
                    chip_smoke.MARG_KEPT: chip_smoke.kept_error(A, R, exact, m)}
            identical = torch.equal(R, again)
            print(f"{label} {tuple(A.shape)}: {who} " + ", ".join(
                f"{n} {v:.2e}" for n, v in errs.items()) + f"; repeat bit-identical {identical}",
                flush=True)
            if not (identical and all(v <= chip_smoke.marg_bound(n, "float32")
                                      for n, v in errs.items())):
                raise AssertionError(f"{label}: {who} is not within the [14m] bounds, or a "
                                     "repeat differs")
    block = chip_smoke.make_blocker(dev)
    out = {}
    for label, (A, head, _) in stacks.items():
        calls = {who: lambda k=k: k(A, head=head) for who, k in sources.items()}
        out[label] = in_turns(label, "marg_qr", calls, block)
        out[label]["floor"] = floor_ms(label, "marg_qr",
                                       lambda: mc.latency_floor("marg_qr", A, head=head), block)
        empty = lambda: mc._qr_launch(True, A, head, earlier._fn, earlier._limits_fn)
        fl = dict(queued=chip_smoke.cuda_ms(empty, reps=10, blocker=block),
                  alone=chip_smoke.cuda_ms(empty))
        print(f"({label}) marg_qr, latency floor of the earlier source's launch: "
              f"{fl['queued']:.4f} ms behind a full queue, {fl['alone']:.4f} ms alone", flush=True)
        out[label]["earlier_floor"] = fl
        bound, by, nbytes, flops = chip_smoke.marg_bound_ms(None, A, "marg_qr")
        lib = chip_smoke.cuda_ms(lambda: torch.linalg.qr(A, mode="r"), n=5, blocker=block)
        print(f"({label}) bound {bound:.6f} ms by {by} ({nbytes} B, {flops / 1e6:.3f} MFLOP); "
              f"torch.linalg.qr of the same stack {lib:.4f} ms", flush=True)
        out[label].update(bound_ms=bound, bound_by=by, library_ms=lib,
                          shape=list(A.shape), head=head)
    print(json.dumps({"card": smi, "times_ms": out}))
    return 0


def bind_marg_depth(so):
    """A built ``csrc/marg_qr.cu``'s ``marg_depth_launch`` behind
    ``marg_cuda``'s wrapper class."""
    from lfvio_tpu_torch.backend import marg_cuda as mc

    kernel = mc.MargDepthKernel()
    kernel._fn = so.marg_depth_launch
    kernel._fn.argtypes, kernel._fn.restype = mc._DEPTH_ARGTYPES, ctypes.c_int
    return kernel


def depth_main(argv):
    """``depth OTHER_MARG_QR_CU``: the other source's marg_depth and this
    tree's in turns."""
    import torch

    import chip_smoke
    from lfvio_tpu_torch.backend import marg_cuda as mc

    dev = card_or_usage("depth", argv, "OTHER_MARG_QR_CU")
    if dev is None:
        return 2
    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    sources = {Path(argv[0]).name: bind_marg_depth(build_earlier_lib(Path(argv[0]), "marg_qr")),
               "this": mc.marg_depth}
    bound = chip_smoke.MARG_BOUNDS["float32"]
    inputs = chip_smoke.depth_inputs(dev)

    def targets(view):
        return (("view", "the stack's view", view), ("own", "a tensor of its own", None))

    for label, (depth_args, view) in inputs.items():
        ref = mc.depth_plain(*depth_args)
        ref64 = mc.depth_plain(*chip_smoke.to_f64(depth_args))
        plain64 = chip_smoke.depth_error(depth_args, ref.double(), ref64)
        for who, kernel in sources.items():
            for _, where, out in targets(view):
                got = kernel(*depth_args, out=out).clone()
                again = kernel(*depth_args, out=out)
                err = chip_smoke.depth_error(depth_args, got, ref)
                err64 = chip_smoke.depth_error(depth_args, got.double(), ref64)
                same = torch.equal(got, again)
                print(f"{label} {who} into {where}: {err:.2e} of each slot's scale from "
                      f"depth_plain, {err64:.2e} from depth_plain in f64 on the inputs upcast "
                      f"(depth_plain in f32 {plain64:.2e}); repeat bit-identical {same}",
                      flush=True)
                if not (same and err <= bound):
                    raise AssertionError(f"{label}: {who} is not within {bound} of "
                                         "depth_plain, or a repeat differs")
    block = chip_smoke.make_blocker(dev)
    order = list(sources) + list(sources)[::-1]
    out = {}
    for label, (depth_args, view) in inputs.items():
        nbound, by, nbytes, _ = chip_smoke.marg_bound_ms(depth_args, view, "marg_depth")
        out[label] = dict(bound_ms=nbound, bound_by=by, bytes=nbytes,
                          view_offset_bytes=view.data_ptr() % 16)
        for key, where, o in targets(view):
            turns = []
            for who in order:
                k = sources[who]
                turns.append((who, chip_smoke.cuda_ms(lambda: k(*depth_args, out=o), reps=10,
                                                      blocker=block)))
                print(f"({label}) marg_depth into {where}, {who}: {turns[-1][1]:.4f} ms behind a full queue, at "
                      f"{100 * nbound / turns[-1][1]:.1f}% of the bound {nbound:.6f} ms", flush=True)
            alone = {who: chip_smoke.cuda_ms(lambda k=k: k(*depth_args, out=o))
                     for who, k in sources.items()}
            floors = {}
            for who, k in sources.items():
                fn = k._fn
                empty = lambda: mc._depth_launch("empty", *depth_args, out=o, fn=fn)
                floors[who] = dict(queued=chip_smoke.cuda_ms(empty, reps=10, blocker=block),
                                   alone=chip_smoke.cuda_ms(empty))
            print(f"({label}) marg_depth into {where}: launched alone " + ", ".join(
                f"{w} {v:.4f} ms" for w, v in alone.items()) + "; latency floor (the empty "
                "kernel) behind a full queue / alone " + ", ".join(
                f"{w} {v['queued']:.4f} / {v['alone']:.4f} ms" for w, v in floors.items()),
                flush=True)
            out[label][key] = dict(turns=turns, alone=alone, floor=floors)
    print(json.dumps({"card": smi, "times_ms": out}))
    return 0


def main(argv):
    modes = {"tree": tree_main, "proj": proj_main, "imu": imu_main, "rows": rows_main,
             "eig": eig_main, "relo": relo_main, "marg": marg_main, "depth": depth_main}
    if not argv or argv[0] not in modes:
        print(f"usage: {sys.argv[0]} tree OTHER_TREE | proj EARLIER_PROJ_FACTOR_CU | "
              "imu EARLIER_IMU_FACTOR_CU | rows EARLIER_PROJ_FACTOR_CU | "
              "eig EARLIER_SYM_EIG_CU | relo EARLIER_PROJ_FACTOR_CU | marg EARLIER_MARG_QR_CU | "
              "depth OTHER_MARG_QR_CU",
              file=sys.stderr)
        return 2
    return modes[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
