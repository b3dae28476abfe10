"""Batched symmetric eigendecomposition of small matrices (``csrc/sym_eig.cu``).

``sym_eig(A)`` has the contract of ``torch.linalg.eigh(A)`` for
A [..., n, n] with n <= 9 in float32 or float64: the lower triangle is read,
eigenvalues come out ascending and eigenvectors as unit columns, their signs
arbitrary (every caller is sign-invariant). On a CUDA tensor it launches the
cyclic-Jacobi kernel on the current stream (one thread per matrix for
n <= 4, one warp for larger n) or raises; it never calls the library, whose
``eigh`` reads its error flag on the host and so could neither run without a
wait nor be captured in a CUDA graph. On a CPU tensor it is the plain
version, ``torch.linalg.eigh``. ``sym_eig.launches`` counts kernel launches.

It stands where the JAX package's jitted programs call ``jnp.linalg.eigh``
(``lfvio_tpu/backend/triangulate.py:69``, ``lfvio_tpu/frontend/ransac.py:36``)
and, through ``frontend/ransac.py::_solve_E``'s projection, ``svd`` (``:40``).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import register_kernel

MAX_N = 9
_DTYPES = {torch.float32: 0, torch.float64: 1}


def sym_eig_plain(A):
    """The plain version: the library's eigendecomposition."""
    return torch.linalg.eigh(A)


class SymEigKernel:
    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            from ..frontend.klt_cuda import library

            fn = library("sym_eig").sym_eig_launch
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [P, P, P, I, I, I, P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, A):
        if not A.is_cuda:
            return sym_eig_plain(A)
        n = A.shape[-1]
        if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N or A.dtype not in _DTYPES:
            raise ValueError(f"sym_eig: takes [..., n, n] float32 or float64 with n <= {MAX_N}, "
                             f"got {A.dtype} {tuple(A.shape)}")
        batch_shape = A.shape[:-2]
        a = A.reshape(-1, n, n).contiguous()
        B = a.shape[0]
        w = torch.empty((B, n), dtype=A.dtype, device=A.device)
        V = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
        if B:
            with torch.cuda.device(A.device):
                err = self._launcher()(a.data_ptr(), w.data_ptr(), V.data_ptr(), B, n,
                                       _DTYPES[A.dtype],
                                       torch.cuda.current_stream(A.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"sym_eig kernel launch failed: cudaError {err}")
            self.launches += 1
        return w.reshape(*batch_shape, n), V.reshape(*batch_shape, n, n)


sym_eig = register_kernel(SymEigKernel())
