"""Where the time of one relo_normal launch goes, on one CUDA card: clock64
stamps at its phase boundaries.

    python3 relo_stamps.py                     (beside chip_smoke.py)

Builds this tree's ``csrc/proj_factor.cu`` once more with stamps written
into a device array at the phases of ``relo_normal_kernel``'s block of rank
0 in its cluster (the kernel's start; thread 0's key stored; its place in
the list found; each warp's rows written; each warp's partial sums done;
each warp's adds into H6 done, before the last cluster barrier), launches
it behind ``chip_smoke.make_blocker`` (the L2 emptied, as the ``[14r]``
times are taken) at three f32 windows (``relo_layout`` 11 frames / 256
slots / anchors at frame 0 / one camera, like phase 6r's; ``relo_window``'s
two cameras; ``relo_layout`` 21 frames / 384 slots / spread / two cameras),
and prints the card's line and, for each window, the median over five
launches of each stamp in SM cycles from the kernel's start. Stamps are
read on one SM (each SM has its own clock), and a stamp is placed before a
barrier, never after one (a read of the clock may move across it).
"""

import ctypes
import sys

R0 = "  if (rank == 0 && tid == 0) relo_stamps[{}] = clock64();\n"
RW = "  if (rank == 0 && (tid & 31) == 0) relo_stamps[{} + (tid >> 5)] = clock64();\n"
STAMPS = [  # (text in the kernel, the stamp put before it)
    ("  // The slot's key; where kept, the loads of what its row reads and of what", R0.format(0)),
    ("  __syncthreads();  // every key and tile\n", R0.format(1)),
    ("  if (k < W1) {\n    T r0, r1, w, cst, J[2][26];", R0.format(2)),
    ("  __syncthreads();  // every row and segment\n", RW.format(8)),
    ("  // Each sum into its place (and its other place) in H6 or b6: block rank", RW.format(16)),
    ("  cluster.sync();  // no block leaves while another reads its shared memory\n",
     RW.format(24)),
]


def stamped(text):
    """The source with the stamps, and a launcher that reads them back."""
    text = text.replace("#include <stdint.h>\n",
                        "#include <stdint.h>\n__device__ long long relo_stamps[48];\n", 1)
    for anchor, stamp in STAMPS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"relo_stamps.py: the kernel no longer has {anchor!r}")
        text = text.replace(anchor, stamp + anchor)
    return text + ('\nextern "C" int relo_stamps_read(long long* out) {\n'
                   '  return (int)cudaMemcpyFromSymbol(out, relo_stamps, sizeof(relo_stamps));\n}\n')


def main():
    import numpy as np
    import torch

    import chip_smoke
    import turns
    from lfvio_tpu_torch.backend import relo_cuda as rc
    from lfvio_tpu_torch.backend.state import n_cams_of, pose_dim
    from lfvio_tpu_torch.frontend import klt_cuda

    if not torch.cuda.is_available():
        print("relo_stamps.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi_line(), flush=True)
    src = klt_cuda.BUILD_DIR / "proj_factor_stamped.cu"
    klt_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(stamped(open(rc.__file__.replace("backend/relo_cuda.py",
                                                    "csrc/proj_factor.cu")).read()))
    so = turns.build_earlier_lib(src, "proj_factor", "stamped")
    so.relo_launch.argtypes, so.relo_launch.restype = rc._ARGTYPES, ctypes.c_int
    so.relo_stamps_read.argtypes, so.relo_stamps_read.restype = [ctypes.c_void_p], ctypes.c_int
    kernel = rc.ReloKernel(normal=True)
    kernel._fn = so.relo_launch
    block = chip_smoke.make_blocker(dev)
    cases = {"11 frames, 256 slots, anchors at frame 0, one camera":
                 chip_smoke.relo_layout(dev, torch.float32, 11, 256, 1, "front"),
             "relo_window, 64 slots, two cameras": chip_smoke.relo_window(dev, torch.float32, 2),
             "21 frames, 384 slots, spread, two cameras":
                 chip_smoke.relo_layout(dev, torch.float32, 21, 384, 2, "spread")}
    names = {"key stored": [1], "place found": [2], "rows (last warp)": list(range(8, 16)),
             "partial sums (last warp)": list(range(16, 24)),
             "adds (last warp)": list(range(24, 32))}
    for label, (state, grid, cfg, relo) in cases.items():
        F, W1 = grid.valid.shape
        D6 = pose_dim(W1, n_cams_of(state)) + 6
        z = lambda *s: torch.zeros(s, dtype=state.p.dtype, device=dev)
        sums = (z(D6, D6), z(D6, F), z(F), z(D6), z(F))
        runs = []
        for _ in range(5):
            block()
            kernel(*sums, state, grid, *relo, cfg)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 48)()
            if so.relo_stamps_read(ctypes.addressof(buf)) != 0:
                raise RuntimeError("relo_stamps.py: reading the stamps failed")
            s = np.asarray(list(buf), dtype=np.int64)
            runs.append({k: int(max(s[i] for i in ix) - s[0]) for k, ix in names.items()})
        med = {k: int(np.median([r[k] for r in runs])) for k in names}
        print(f"{label}: SM cycles from the kernel's start, median of 5: "
              + ", ".join(f"{k} {v}" for k, v in med.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
