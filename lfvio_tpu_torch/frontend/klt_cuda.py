"""The LK level kernel (``csrc/lk_level.cu``): build, binding and level loop.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, keyed by a hash of the
source, under ``lfvio_tpu_torch/build/``, and loaded with ``ctypes``.

``lk_level`` is the kernel's wrapper. On a CUDA tensor it launches the
kernel on the current stream or raises; there is no fallback. On a CPU
tensor it runs the plain version, ``klt.track_level``. ``lk_level.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from . import klt

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lk_level.cu"
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


def build(verbose: bool = False) -> Path:
    """Compile the kernel if no library for this source exists yet; returns
    the library's path. ``verbose`` adds ``-Xptxas -v`` and prints what the
    compiler reports (registers, shared memory, spills)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"liblk_level_{digest}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, lib)
    return lib


class LkLevelKernel:
    """Wrapper of the LK level kernel with the signature of
    ``klt.track_level``: (img_prev, img_next, pos [N,2], guess [N,2],
    valid [N] bool, win, n_iters) -> (guess [N,2], ok [N] bool)."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            fn = ctypes.CDLL(str(build())).lk_level_launch
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, img_prev, img_next, pos, guess, valid,
                 win: int = klt.WIN, n_iters: int = klt.N_ITERS):
        if not img_prev.is_cuda:
            return klt.track_level(img_prev, img_next, pos, guess, valid, win, n_iters)
        dev = img_prev.device
        N = pos.shape[0]
        for name, t, shape, dtype in (
            ("img_next", img_next, img_prev.shape, torch.float32),
            ("pos", pos, (N, 2), torch.float32),
            ("guess", guess, (N, 2), torch.float32),
            ("valid", valid, (N,), torch.bool),
        ):
            if t.device != dev or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(
                    f"lk_level: {name} must be {dtype} {tuple(shape)} on {dev}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        if img_prev.dtype != torch.float32 or img_prev.dim() != 2:
            raise ValueError("lk_level: images must be 2-D float32")
        if not (win >= 1 and n_iters >= 0):
            raise ValueError(f"lk_level: bad win={win} n_iters={n_iters}")
        pad = klt.PAD
        prev_pad = F.pad(img_prev[None, None], (pad,) * 4, mode="replicate")[0, 0]
        next_pad = F.pad(img_next[None, None], (pad,) * 4, mode="replicate")[0, 0]
        Hp, Wp = prev_pad.shape
        pos = pos.contiguous()
        guess = guess.contiguous()
        valid = valid.contiguous()
        g_out = torch.empty((N, 2), dtype=torch.float32, device=dev)
        ok_out = torch.empty((N,), dtype=torch.bool, device=dev)
        min_eig = torch.empty((N,), dtype=torch.float32, device=dev)
        fn = self._load()
        with torch.cuda.device(dev):  # launch in the context of the tensors' card
            err = fn(
                prev_pad.data_ptr(), next_pad.data_ptr(), Hp, Wp,
                pos.data_ptr(), guess.data_ptr(), valid.data_ptr(), N,
                pad, int(win), int(n_iters),
                g_out.data_ptr(), ok_out.data_ptr(), min_eig.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"lk_level kernel launch failed: cudaError {err}")
        self.launches += 1
        return g_out, ok_out


lk_level = LkLevelKernel()


def pyramidal_lk(pyr_prev, pyr_next, pts_prev, valid, n_levels: int = 3,
                 refine_win: int = 0):
    """``klt.pyramidal_lk`` with every level step (the refine pass
    included) through ``lk_level``."""
    return klt.lk_pyramid(lk_level, pyr_prev, pyr_next, pts_prev, valid,
                          n_levels, refine_win)
