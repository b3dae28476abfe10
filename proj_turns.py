"""The LM solve's projection linearization as this tree launches it (one
``proj_normal`` launch) against the rows + assemble pair of an earlier
``csrc/proj_factor.cu`` (one with ``proj_rows_launch`` and
``proj_assemble_launch``), in turns on one CUDA card.

    python3 proj_turns.py EARLIER_PROJ_FACTOR_CU     (beside chip_smoke.py)

Builds the given source with this tree's nvcc flags into a library of its
own, warms up an estimator in bench.py's default configuration (a) and in
its high-rate one (b) (``chip_smoke.warm_estimator``), and at each one's
next solve inputs (f32) times, behind a full queue
(``chip_smoke.cuda_ms`` with its blocker), the pair (a rows launch, then an
assemble launch over its rows, every output allocated per call as the
earlier wrappers did) and ``proj_normal``, in turns pair, normal, normal,
pair; then each launched alone. Both are held against the plain version
within ``chip_smoke.PROJ_BOUNDS`` of each output's scale first. Prints the
card's line, one line a time and one JSON line of all of them last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from lfvio_tpu_torch.backend import proj_cuda as pc
from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim
from lfvio_tpu_torch.frontend import klt_cuda


def build_earlier(src):
    """The earlier source built into a library of its own; its two
    launchers, bound."""
    lib = klt_cuda.BUILD_DIR / "libproj_factor_earlier.so"
    klt_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([klt_cuda.nvcc_path(), *klt_cuda.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I, Dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    rows, asm = so.proj_rows_launch, so.proj_assemble_launch
    rows.argtypes = [P] * 13 + [I, I, I, Dbl, Dbl, I, I, P, P, P, P, P]
    asm.argtypes = [P] * 7 + [I] * 6 + [P] * 6
    rows.restype = asm.restype = I
    return rows, asm


def pair_fn(rows_launch, asm_launch, state, grid, cfg):
    """One linearization through the earlier pair: (H_pp, H_pl, H_ll, b_p,
    b_l, cost terms)."""
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


def main(argv):
    if not torch.cuda.is_available():
        print("proj_turns: no CUDA device", file=sys.stderr)
        return 2
    if len(argv) != 1:
        print(f"usage: {sys.argv[0]} EARLIER_PROJ_FACTOR_CU", file=sys.stderr)
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
