"""Visual-inertial bootstrap on the host (numpy, float64).

The port's own copy of ``lfvio_tpu.vinit``: relative pose, global SfM,
bearing PnP, visual-IMU alignment and the extrinsic-rotation calibrator.
It imports numpy and ``..geom.host`` only.
"""

from .pnp import pnp_bearing_gn
from .relative import solve_relative_rt
from .sfm import global_sfm
from .alignment import visual_imu_alignment
from .ex_rotation import ExtrinsicRotationCalibrator
