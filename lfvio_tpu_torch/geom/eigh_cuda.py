"""Batched symmetric eigendecomposition of small matrices (``csrc/sym_eig.cu``).

``sym_eig(A)`` has the contract of ``torch.linalg.eigh(A)`` for
A [..., n, n] with n <= 9 in float32 or float64: the lower triangle is read,
eigenvalues come out ascending and eigenvectors as unit columns, their signs
arbitrary (every caller is sign-invariant). On a CUDA tensor it launches the
cyclic-Jacobi kernel on the current stream (a 4-lane group per matrix for
n <= 4, a 16-lane group for larger n) or raises; it never calls the
library, whose ``eigh`` reads its error flag on the host and so could
neither run without a wait nor be captured in a CUDA graph. On a CPU tensor it is the plain
version, ``torch.linalg.eigh``. ``sym_eig.launches`` counts kernel launches.
``latency_floor(A)`` launches the source's empty kernel with the grid, block
and arguments of ``sym_eig(A)``'s launch (card only, counted nowhere).

It stands where the JAX package's jitted programs call ``jnp.linalg.eigh``
(``lfvio_tpu/backend/triangulate.py:69``, ``lfvio_tpu/frontend/ransac.py:36``)
and, through ``frontend/ransac.py::_solve_E``'s projection, ``svd`` (``:40``).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import register_kernel

MAX_N = 9
MAX_SWEEPS = 16  # csrc/sym_eig.cu's cap on the Jacobi sweeps of a matrix
_DTYPES = {torch.float32: 0, torch.float64: 1}


def sym_eig_plain(A):
    """The plain version: the library's eigendecomposition."""
    return torch.linalg.eigh(A)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind(name):
    from ..frontend.klt_cuda import library

    fn = getattr(library("sym_eig"), name)
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, A, sweeps):
    """One call of ``fn`` (``sym_eig_launch`` or ``sym_eig_empty_launch``,
    which take the same arguments) on A [..., n, n] (checked), into outputs
    allocated here: (w, V, counts or None), shaped as the batch, and whether
    it launched (an empty batch does not)."""
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N or A.dtype not in _DTYPES:
        raise ValueError(f"sym_eig: takes [..., n, n] float32 or float64 with n <= {MAX_N}, "
                         f"got {A.dtype} {tuple(A.shape)}")
    batch_shape = A.shape[:-2]
    a = A.reshape(-1, n, n).contiguous()
    B = a.shape[0]
    w = torch.empty((B, n), dtype=A.dtype, device=A.device)
    V = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
    counts = torch.empty(B, dtype=torch.int32, device=A.device) if sweeps else None
    if B:
        with torch.cuda.device(A.device):
            err = fn(a.data_ptr(), w.data_ptr(), V.data_ptr(),
                     counts.data_ptr() if sweeps else None, B, n, _DTYPES[A.dtype],
                     torch.cuda.current_stream(A.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sym_eig kernel launch failed: cudaError {err}")
    out = (w.reshape(*batch_shape, n), V.reshape(*batch_shape, n, n),
           counts.reshape(batch_shape) if sweeps else None)
    return out, B > 0


class SymEigKernel:
    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, A, sweeps=False):
        """(w, V); with ``sweeps`` also each matrix's count of Jacobi sweeps
        (int32, the batch shape), which only the kernel has."""
        if not A.is_cuda:
            if sweeps:
                raise ValueError("sym_eig: sweep counts come from the kernel, and a CPU tensor "
                                 "takes the plain version")
            return sym_eig_plain(A)
        if self._fn is None:
            self._fn = _bind("sym_eig_launch")
        out, launched = _launch(self._fn, A, sweeps)
        self.launches += launched
        return out if sweeps else out[:2]


sym_eig = register_kernel(SymEigKernel())
_empty_fn = None


def latency_floor(A):
    """One launch of ``csrc/sym_eig.cu``'s empty kernel with the grid, block
    and arguments of ``sym_eig(A)``'s launch, through the wrapper's ctypes
    path and allocating the outputs it allocates (returned): the part of
    that launch's time that no design of the kernel removes. Card only;
    adds to no ``launches``."""
    global _empty_fn
    if not A.is_cuda:
        raise ValueError("latency_floor: times a launch on the card; the input lies on the CPU")
    if _empty_fn is None:
        _empty_fn = _bind("sym_eig_empty_launch")
    return _launch(_empty_fn, A, False)[0][:2]
