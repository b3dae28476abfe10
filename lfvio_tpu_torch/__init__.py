"""lfvio_tpu_torch — the PyTorch + CUDA port of lfvio_tpu.

The JAX package ``lfvio_tpu`` is the reference; this package mirrors its
layout (geom, cam, frontend, imu, backend, vinit, runtime) so each module's
counterpart is easy to find. It imports torch and numpy, never JAX and
nothing of the JAX package: the numpy modules it needs from there (the
``vinit`` bootstrap among them) are its own copies.

A frame's pyramidal LK runs as one launch of a hand-written CUDA kernel
(``csrc/lk_pyramid.cu``, bound in ``frontend/klt_cuda.py``) on CUDA tensors;
everything else is torch ops. The entry points (``FrontEnd``, ``Estimator``,
``SyntheticWorld``) run on the CUDA card unless the caller names a device.
"""

__version__ = "0.1.0"
