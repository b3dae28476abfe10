"""The float32 relocalization rows on ``chip_smoke.relo_layout``'s windows,
on one CUDA card: how far the relo kernels, an earlier source's and the
plain version each land from float64 arithmetic on the same float32 inputs.

    python3 relo_f32_spread.py [EARLIER_PROJ_FACTOR_CU]     (beside chip_smoke.py)

For each window of the card tests (11 and 21 frames, 256 and 384 slots,
anchors 96% at frame 0 or spread evenly, one camera or two with the
extrinsics estimated) in float32: ``relo_normal`` and ``relo_cost`` of this
tree, of EARLIER_PROJ_FACTOR_CU (a ``csrc/proj_factor.cu`` with the same
``relo_launch``, built with this tree's nvcc flags behind ``relo_cuda``'s
wrapper class) where given, and the plain version, each against the plain
version run in float64 on the float32 inputs upcast, relative to each
output's scale (``chip_smoke.relo_scales``, the scale ``[14r]`` holds
RELO_BOUNDS against); then kernel against plain, as ``[14r]`` compares
them. Prints the card's line and a line a window, the largest error over
the outputs and the output it is in.
"""

import ctypes
import sys


def main(argv):
    import torch

    import chip_smoke
    import turns
    from lfvio_tpu_torch.backend import relo_cuda as rc

    if not torch.cuda.is_available():
        print("relo_f32_spread.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi_line(), flush=True)
    sources = {"this": None}
    if argv:
        fn = turns.build_earlier_lib(argv[0], "proj_factor").relo_launch
        fn.argtypes, fn.restype = rc._ARGTYPES, ctypes.c_int
        sources["earlier"] = {"relo_normal": rc.ReloKernel(normal=True),
                              "relo_cost": rc.ReloKernel(normal=False)}
        for k in sources["earlier"].values():
            k._fn = fn

    def worst(x, y, scale):
        e = {n: float((x[n].double() - y[n].double()).abs().max()) / scale[n] for n in scale}
        n = max(e, key=e.get)
        return f"{e[n]:.2e} ({n})"

    for W1 in (11, 21):
        for F in (256, 384):
            for layout in chip_smoke.RELO_LAYOUTS:
                for C in (1, 2):
                    args = chip_smoke.relo_layout(dev, torch.float32, W1, F, C, layout)
                    exact = chip_smoke.relo_outputs(chip_smoke.relo_upcast(args), plain=True)
                    scale = chip_smoke.relo_scales(chip_smoke.relo_upcast(args))
                    plain = chip_smoke.relo_outputs(args, plain=True)
                    outs = {who: chip_smoke.relo_outputs(args, kernels=k)
                            for who, k in sources.items()}
                    print(f"{W1} frames, {F} slots, {layout}, {C} camera(s): against f64 "
                          "arithmetic " + ", ".join(f"{who} {worst(o, exact, scale)}"
                                                    for who, o in outs.items())
                          + f", plain f32 {worst(plain, exact, scale)}; against the plain "
                          "version " + ", ".join(f"{who} {worst(o, plain, scale)}"
                                                 for who, o in outs.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
