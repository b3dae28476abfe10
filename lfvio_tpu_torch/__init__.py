"""lfvio_tpu_torch — the PyTorch + CUDA port of lfvio_tpu.

The JAX package ``lfvio_tpu`` is the reference; this package mirrors its
layout (geom, cam, frontend, imu, backend, runtime) so each module's
counterpart is easy to find. It imports torch and numpy and never JAX: the
one import from the JAX package is the pure-numpy bootstrap
``lfvio_tpu.vinit``, which is shared rather than ported.

The LK level step runs as a hand-written CUDA kernel
(``csrc/lk_level.cu``, bound in ``frontend/klt_cuda.py``) on CUDA tensors;
everything else is torch ops.
"""

__version__ = "0.1.0"
