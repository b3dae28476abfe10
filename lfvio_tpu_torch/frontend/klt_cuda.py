"""The LK kernel (``csrc/lk_pyramid.cu``): build and binding; the build of
every kernel source of the port.

Each CUDA source under ``csrc/`` is compiled for ``sm_90a`` into a shared
library of its own with a plain C interface at first use, keyed by a hash
of the source and the flags, under ``lfvio_tpu_torch/build/``: one ``nvcc``
per source, all started together. Libraries are loaded with ``ctypes``.

``lk_pyramid`` is the wrapper of the fused launch: every pyramid level and
the refine pass of a frame in one launch. ``pyramidal_lk``, which the
FrontEnd calls, is that wrapper. ``lk_level`` is the wrapper of one level
step from a given guess (``klt.track_level``): a launch of the same kernel
with a one-row pass table. ``pyramidal_lk_pallas`` is the wrapper of the
source's Pallas-geometry kernel (``klt.pyramidal_lk_pallas``, one launch a
frame, staging a band of the search window), which
``FrontEnd(use_pallas=True)`` calls. On a CUDA tensor a
wrapper launches the kernel on the current stream or raises; there is no
fallback. On a CPU tensor it runs the plain version in ``klt.py``. Each
wrapper's ``launches`` counts its kernel launches; the wrappers are
registered with ``device.register_kernel``, so a launch inside a CUDA
graph (the FrontEnd's step programs) is counted at each replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..device import register_kernel
from . import klt

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f"{stem}.cu"
                for stem in ("lk_pyramid", "sym_eig", "proj_factor", "imu_factor", "marg_qr",
                           "graph_cond"))
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict:
    """Compile every kernel source whose library does not exist yet, one
    ``nvcc`` per source, all started together; returns {source stem:
    library path}. ``verbose`` rebuilds all of them with ``-Xptxas -v`` and
    prints what the compiler reports for each kernel (registers, shared
    memory, spills)."""
    libs = {src.stem: _lib_path(src) for src in SOURCES}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src in SOURCES:
        lib = libs[src.stem]
        if lib.exists() and not verbose:
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src, proc, tmp, lib))
    for src, proc, tmp, lib in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
        if verbose:
            print(f"{src.name}:\n{out}{err}", flush=True)
        os.replace(tmp, lib)
    return libs


_libs = {}


def library(stem: str):
    """The loaded library of ``csrc/<stem>.cu``, built at first use."""
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(build()[stem]))
    return _libs[stem]


def max_levels() -> int:
    """``csrc/lk_pyramid.cu``'s MAX_LEVELS: the pyramid levels a launch
    takes, level 0 included."""
    return library("lk_pyramid").lk_pyramid_max_levels()


_fn = None


def _launch(name, pyr_prev, pyr_next, shapes, passes, has_refine, pts, valid, ok_out,
            guess=None, pts_out=None, guess_out=None, iters=None, restages=None, pallas=False):
    """One launch of ``lk_pyramid_kernel`` (with ``pallas``,
    ``lk_pallas_kernel``) on the current stream of the tensors' card.
    ``passes`` are rows (level, window, iterations, skipped) in the order
    they run; ``guess``, ``pts_out``, ``guess_out``, ``iters``
    and ``restages`` may be None; ``pallas`` selects the Pallas geometry.
    Raises if the launch fails."""
    global _fn
    if _fn is None:
        fn = library("lk_pyramid").lk_pyramid_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, P, P, P, P, I, I, ctypes.c_float,
                       P, P, P, I, I, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
        _fn = fn
    dev = pts.device
    nl = len(shapes)
    ptrs = lambda pyr: (ctypes.c_void_p * nl)(*[pyr[l].data_ptr() for l in range(nl)])
    ints = lambda vals: (ctypes.c_int * len(vals))(*vals)
    ptr = lambda t: None if t is None else t.data_ptr()
    tiles = [klt.pallas_tile_shape(*s) for s in shapes] if pallas else [(0, 0)] * nl
    with torch.cuda.device(dev):  # launch in the context of the tensors' card
        err = _fn(
            ptrs(pyr_prev), ptrs(pyr_next), ints([s[0] for s in shapes]),
            ints([s[1] for s in shapes]), ints([s[1] for s in shapes]),
            ints([t[0] for t in tiles]), ints([t[1] for t in tiles]), int(pallas), nl,
            *(ints([p[k] for p in passes]) for k in range(4)), len(passes),
            int(has_refine), klt.REFINE_MAX_MOVE,
            pts.data_ptr(), valid.data_ptr(), ptr(guess), pts.shape[0], klt.PAD,
            ptr(pts_out), ok_out.data_ptr(), ptr(guess_out), ptr(iters), ptr(restages),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err == -1:
        raise ValueError(f"{name}: the kernel does not take these levels or windows: "
                         f"levels {shapes}, passes {passes}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _check_tensors(name, dev, specs):
    """Raise unless every (label, tensor, shape, dtype) lies on ``dev`` with
    that shape and dtype."""
    for label, t, shape, dtype in specs:
        if t.device != dev or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(
                f"{name}: {label} must be {dtype} {tuple(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


class LkLevelKernel:
    """Wrapper of one LK level step with the signature of
    ``klt.track_level``: (img_prev, img_next, pos [N,2], guess [N,2],
    valid [N] bool, win, n_iters) -> (guess [N,2], ok [N] bool)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, img_prev, img_next, pos, guess, valid,
                 win: int = klt.WIN, n_iters: int = klt.N_ITERS):
        if not img_prev.is_cuda:
            return klt.track_level(img_prev, img_next, pos, guess, valid, win, n_iters)
        dev = img_prev.device
        N = pos.shape[0]
        if img_prev.dtype != torch.float32 or img_prev.dim() != 2:
            raise ValueError("lk_level: images must be 2-D float32")
        _check_tensors("lk_level", dev, (
            ("img_next", img_next, img_prev.shape, torch.float32),
            ("pos", pos, (N, 2), torch.float32),
            ("guess", guess, (N, 2), torch.float32),
            ("valid", valid, (N,), torch.bool),
        ))
        if not (img_prev.is_contiguous() and img_next.is_contiguous()):
            raise ValueError("lk_level: images must be contiguous")
        if not (win >= 1 and n_iters >= 0):
            raise ValueError(f"lk_level: bad win={win} n_iters={n_iters}")
        g_out = torch.empty((N, 2), dtype=torch.float32, device=dev)
        ok_out = torch.empty((N,), dtype=torch.bool, device=dev)
        if N == 0:  # an empty grid is no launch
            return g_out, ok_out
        _launch("lk_level", [img_prev], [img_next], [tuple(img_prev.shape)],
                [(0, int(win), int(n_iters), 0)], False, pos.contiguous(),
                valid.contiguous(), ok_out, guess=guess.contiguous(), guess_out=g_out)
        self.launches += 1
        return g_out, ok_out


lk_level = register_kernel(LkLevelKernel())


def _pass_table(level_shapes, n_levels, win, n_iters, refine_win, refine_iters):
    """The passes of ``klt.lk_pyramid`` in the order they run, as rows
    (level, window, iterations, skipped): levels ``n_levels`` .. 0, a level
    whose smaller side is under 8 px skipped, then the refine pass."""
    passes = [(lvl, win, n_iters, int(min(level_shapes[lvl]) < 8))
              for lvl in range(n_levels, -1, -1)]
    if refine_win:
        passes.append((0, int(refine_win), refine_iters, 0))
    return passes


def _check_pyramids(pyr_prev, pyr_next, n_levels):
    """Raise on pyramids the fused kernel does not take; returns the level
    shapes and the working dtype: float32 on a card (all the kernel takes),
    the first level's dtype on the CPU (the plain version takes any).
    Needs no card."""
    if n_levels < 0:
        raise ValueError(f"lk_pyramid: n_levels must not be negative, got {n_levels}")
    if len(pyr_prev) <= n_levels or len(pyr_next) <= n_levels:
        raise ValueError(f"lk_pyramid: pyramids need {n_levels + 1} levels")
    if pyr_prev[0].is_cuda and n_levels >= (cap := max_levels()):
        raise ValueError(f"lk_pyramid: the kernel takes at most MAX_LEVELS = {cap} "
                         f"levels, level 0 included (n_levels <= {cap - 1}); got "
                         f"n_levels = {n_levels}")
    dev = pyr_prev[0].device
    dtype = torch.float32 if dev.type == "cuda" else pyr_prev[0].dtype
    shapes = []
    for lvl in range(n_levels + 1):
        a, b = pyr_prev[lvl], pyr_next[lvl]
        for name, t in (("pyr_prev", a), ("pyr_next", b)):
            if t.dim() != 2 or t.dtype != dtype or t.device != dev:
                raise ValueError(
                    f"lk_pyramid: {name}[{lvl}] must be 2-D {dtype} on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"lk_pyramid: {name}[{lvl}] must be contiguous")
        if a.shape != b.shape:
            raise ValueError(
                f"lk_pyramid: level {lvl} differs between the pyramids: "
                f"{tuple(a.shape)} and {tuple(b.shape)}")
        if lvl and tuple(a.shape) != tuple(-(-n // 2) for n in shapes[-1]):
            raise ValueError(
                f"lk_pyramid: level {lvl} is {tuple(a.shape)}, not half of level "
                f"{lvl - 1} {shapes[-1]} rounded up, as gaussian_pyramid makes it")
        shapes.append(tuple(a.shape))
    return shapes, dtype


class LkPyramidKernel:
    """Wrapper of one fused LK launch a frame, counted in its own
    ``launches``. ``pallas=False``: the signature of ``klt.pyramidal_lk``,
    (pyr_prev, pyr_next, pts [N,2], valid [N] bool, n_levels, refine_win)
    -> (pts_next [N,2], ok [N] bool). ``pallas=True``: the
    Pallas-geometry kernel, the function of ``klt.pyramidal_lk_pallas``,
    which has no refine pass (``refine_win`` must be 0). With ``return_iters`` a
    further result, int32 [N, passes], holds the Gauss-Newton iterations
    each feature took in each pass (levels coarse to fine, then the refine
    pass; -1 where the pass did not run for it). With ``return_restages``
    (the Pallas geometry only) a last one, of the same form, holds the times
    each feature's search band was staged again in each pass, its window
    having left the band."""

    def __init__(self, pallas: bool = False):
        self.pallas = pallas
        self.name = "pyramidal_lk_pallas" if pallas else "lk_pyramid"
        self.launches = 0

    def __call__(self, pyr_prev, pyr_next, pts_prev, valid, n_levels: int = 3,
                 refine_win: int = 0, return_iters: bool = False,
                 return_restages: bool = False):
        name = self.name
        if self.pallas and refine_win:
            raise ValueError(f"{name}: the Pallas geometry has no refine pass")
        if return_restages and not self.pallas:
            raise ValueError(f"{name}: only the Pallas geometry stages a band")
        shapes, dtype = _check_pyramids(pyr_prev, pyr_next, n_levels)
        dev = pyr_prev[0].device
        N = pts_prev.shape[0]
        _check_tensors(name, dev, (
            ("pts_prev", pts_prev, (N, 2), dtype),
            ("valid", valid, (N,), torch.bool),
        ))
        if dev.type != "cuda":
            if return_iters or return_restages:
                raise ValueError(f"{name}: iteration and restage counts come from the kernel only")
            if self.pallas:
                return klt.pyramidal_lk_pallas(pyr_prev, pyr_next, pts_prev, valid, n_levels)
            return klt.pyramidal_lk(pyr_prev, pyr_next, pts_prev, valid, n_levels, refine_win)
        passes = _pass_table(shapes, n_levels, klt.WIN, klt.N_ITERS, refine_win,
                             klt.REFINE_ITERS)
        pts_out = torch.empty((N, 2), dtype=torch.float32, device=dev)
        ok_out = torch.empty((N,), dtype=torch.bool, device=dev)
        counts = lambda want: (torch.full((N, len(passes)), -1, dtype=torch.int32, device=dev)
                               if want else None)
        iters, restages = counts(return_iters), counts(return_restages)
        if N:  # an empty grid is no launch
            _launch(name, pyr_prev, pyr_next, shapes, passes, bool(refine_win),
                    pts_prev.contiguous(), valid.contiguous(), ok_out, pts_out=pts_out,
                    iters=iters, restages=restages, pallas=self.pallas)
            self.launches += 1
        return (pts_out, ok_out) + tuple(c for c in (iters, restages) if c is not None)


lk_pyramid = register_kernel(LkPyramidKernel())
pyramidal_lk = lk_pyramid
pyramidal_lk_pallas = register_kernel(LkPyramidKernel(pallas=True))
