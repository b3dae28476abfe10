"""Intrinsic calibration tooling: port of ``lfvio_tpu.calib`` (reference:
the camera_model calibration CLI, camera_model/src/intrinsic_calib.cc +
src/calib/CameraCalibration.cc).

Calibrates ALL FOUR reference camera models from planar-chessboard
correspondences:
  * :func:`calibrate_scaramuzza` — OCAM/PAL polynomial model (the reference's
    ScaramuzzaCamera::estimateIntrinsics, ScaramuzzaCamera.cc:224-601).
  * :func:`calibrate_pinhole` — Zhang's method + rad-tan refinement.
  * :func:`calibrate_mei` — unified catadioptric (CataCamera;
    CostFunctionFactory.cc:533-822 via calib/CameraCalibration.cc).
  * :func:`calibrate_kannala_brandt` — equidistant fisheye
    (EquidistantCamera).
  * :func:`find_chessboard_corners` — detection wrapper (the reference
    vendors a 2k-LoC OpenCV-based detector, src/chessboard/Chessboard.cc).
"""

from .intrinsic import (
    calibrate_scaramuzza,
    calibrate_pinhole,
    calibrate_mei,
    calibrate_kannala_brandt,
    find_chessboard_corners,
    synth_chessboard_views,
)

__all__ = [
    "calibrate_scaramuzza",
    "calibrate_pinhole",
    "calibrate_mei",
    "calibrate_kannala_brandt",
    "find_chessboard_corners",
    "synth_chessboard_views",
]
