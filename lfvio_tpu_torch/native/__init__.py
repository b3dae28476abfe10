"""ctypes bindings for the native C++ IO runtime (``io_runtime.cpp``).

Port of ``lfvio_tpu.native``: the SPSC-ring measurement synchronizer (the
reference's getMeasurements with boundary interpolation and td pairing)
and a buffered TUM writer. The source is this package's own copy. It is
compiled with ``g++`` at first use into ``lfvio_tpu_torch/build/``, keyed
by a hash of the source and the flags; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "io_runtime.cpp"
BUILD_DIR = SOURCE.parent.parent / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib = None
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def build() -> Path:
    """Compile the shared library if none for this source exists yet;
    returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libioruntime_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load():
    """The loaded library, with every function's argument and result types."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    c_void_p, c_double, c_int, c_int64 = (ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                                          ctypes.c_int64)
    sig = {
        "vio_sync_create": (c_void_p, [c_double, c_int, c_int]),
        "vio_sync_destroy": (None, [c_void_p]),
        "vio_sync_push_imu": (c_int, [c_void_p, c_double, _DOUBLE_P, _DOUBLE_P]),
        "vio_sync_push_frame": (c_int, [c_void_p, c_double, c_int64, ctypes.POINTER(c_int)]),
        "vio_sync_pop": (c_int64, [c_void_p, _DOUBLE_P, _DOUBLE_P, _DOUBLE_P, c_int64,
                                   _DOUBLE_P, ctypes.POINTER(c_int64)]),
        "vio_sync_imu_count": (c_int64, [c_void_p]),
        "vio_sync_frame_count": (c_int64, [c_void_p]),
        "vio_tum_open": (c_void_p, [ctypes.c_char_p]),
        "vio_tum_write": (c_int, [c_void_p, c_double, _DOUBLE_P, _DOUBLE_P]),
        "vio_tum_close": (None, [c_void_p]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


def _vec3(x):
    a = np.ascontiguousarray(x, np.float64)
    if a.shape != (3,):
        raise ValueError(f"expected 3 values, got shape {a.shape}")
    return a


class NativeSynchronizer:
    """Measurement synchronizer backed by the C++ SPSC rings."""

    def __init__(self, td: float = 0.0, imu_capacity: int = 4096,
                 frame_capacity: int = 256, max_samples: int = 512):
        self._lib = load()
        self._h = self._lib.vio_sync_create(td, imu_capacity, frame_capacity)
        if not self._h:
            raise MemoryError("vio_sync_create failed")
        self._max_n = max_samples
        self._dt = np.zeros(max_samples)
        self._acc = np.zeros((max_samples, 3))
        self._gyr = np.zeros((max_samples, 3))

    def push_imu(self, t, acc, gyr):
        acc, gyr = _vec3(acc), _vec3(gyr)
        if self._lib.vio_sync_push_imu(self._h, float(t), acc.ctypes.data_as(_DOUBLE_P),
                                       gyr.ctypes.data_as(_DOUBLE_P)) != 0:
            raise BufferError("IMU ring full")

    def push_frame(self, t, frame_id):
        """Queue a frame; returns True where the stream restarts (a gap of
        more than 1 s or time running backwards)."""
        restart = ctypes.c_int(0)
        if self._lib.vio_sync_push_frame(self._h, float(t), int(frame_id),
                                         ctypes.byref(restart)) != 0:
            raise BufferError("frame ring full")
        return bool(restart.value)

    def pop(self):
        """Returns (frame_t, frame_id, dts, accs, gyrs) or None if no frame
        is ready (needs more IMU)."""
        ft = ctypes.c_double(0)
        fid = ctypes.c_int64(0)
        n = self._lib.vio_sync_pop(
            self._h, self._dt.ctypes.data_as(_DOUBLE_P), self._acc.ctypes.data_as(_DOUBLE_P),
            self._gyr.ctypes.data_as(_DOUBLE_P), self._max_n, ctypes.byref(ft),
            ctypes.byref(fid),
        )
        if n < 0:
            return None
        n = int(n)
        return ft.value, fid.value, self._dt[:n].copy(), self._acc[:n].copy(), self._gyr[:n].copy()

    def close(self):
        if self._h:
            self._lib.vio_sync_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class NativeTumWriter:
    """Buffered TUM trajectory writer ('t tx ty tz qx qy qz qw' lines)."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.vio_tum_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write(self, t, p, q_wxyz):
        p = _vec3(p)
        q = np.ascontiguousarray(q_wxyz, np.float64)
        if q.shape != (4,):
            raise ValueError(f"expected a quaternion of 4 values, got shape {q.shape}")
        self._lib.vio_tum_write(self._h, float(t), p.ctypes.data_as(_DOUBLE_P),
                                q.ctypes.data_as(_DOUBLE_P))

    def close(self):
        if self._h:
            self._lib.vio_tum_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
