"""Run one cell of the benchmark of the PyTorch and CUDA port
(``lfvio_tpu_torch``) once, on the CUDA cards of this machine:

    python3 -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted`` (frames handed over in the window),
``failed`` (published frames of the window whose pose never came),
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the check compared, beside its limit. The same
numbers are the last lines of standard error.

Exits with 2, printing no result, without as many CUDA cards as the cell
asks for, and with 3 if a module of JAX or of the JAX package was loaded,
or if the reference holds anything of the port.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the host's numpy and torch CPU work runs on
# one thread, so that the run does not contend with itself for the cores.
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lfvio_tpu")


def forbidden_modules(names=None, forbidden=FORBIDDEN):
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``forbidden``, compared whole: ``lfvio_tpu_torch`` is not
    ``lfvio_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in forbidden})


REFERENCE = ("vio_bench.reference", "vio_bench.check", "vio_bench.world")


def reference_leaks(modules=None):
    """Names bound in the reference's modules (``REFERENCE``) that belong to
    the port, to JAX or to the JAX package: a module, or an object whose
    module is one of theirs."""
    modules = sys.modules if modules is None else modules
    banned = set(FORBIDDEN) | {"lfvio_tpu_torch"}
    bad = []
    for name, mod in list(modules.items()):
        if mod is None or not name.startswith(REFERENCE):
            continue
        for k, v in vars(mod).items():
            owner = v.__name__ if isinstance(v, type(sys)) else getattr(v, "__module__", None)
            if isinstance(owner, str) and owner.split(".")[0] in banned:
                bad.append(f"{name}.{k}")
    return sorted(bad)


def log(msg):
    print(f"[vio_bench +{time.perf_counter() - T_START:7.2f}s] {msg}", file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, res, traced, device_name, n_devices):
    """The contract's last line from a run's result."""
    from . import cell as C
    from . import trace

    win, chk = res["window"], res["check"]
    dev = {"platform": "gpu", "kind": device_name, "count": n_devices,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": chk["correct"], "attempted": win["frames"], "failed": win["failed"],
            "metrics": C.read_metrics(cell, res, traced), "device": dev}
    sl = win.get("slice") or {}
    if traced and sl:
        dev.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        line["breakdown"] = {"device_ops": trace.top(sl["by_name"]),
                             "idle_gaps": trace.top(sl["idle_by_host"])}
    line["checks"] = chk["numbers"]
    return line


def main(argv=None):
    args = parse(argv)
    import torch

    torch.set_num_threads(1)

    from . import cell as C

    root = Path.cwd()
    cell = C.Cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {cell.chips} CUDA device(s), found {n}: no result")
        return 2
    name = torch.cuda.get_device_name(0)
    log(f"{args.workload} seed {args.seed} on {name}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    res = C.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda", log=log,
                t_start=T_START)
    bad = forbidden_modules() + reference_leaks()
    if bad:
        log(f"JAX, the JAX package or (in the reference) the port was loaded: "
            f"{', '.join(bad)}: no result")
        return 3
    line = result_line(cell, res, bool(args.trace), name, cell.chips)
    log(f"restarts {res['restarts']}, graphs captured in the window {res['graphs_window']}, "
        f"program calls {res['calls']}, ATE {res['ate_m']} m, peak memory "
        f"{res['memory_peak_bytes']} B, check {res['check_s']:.2f} s over {res['check']['seen']}")
    for k, v in line["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
