from .preintegration import (
    ImuNoise,
    Preintegration,
    preintegrate,
    bias_corrected_delta,
    imu_residual,
    whiten_covariance,
    propagate_state_midpoint,
    O_P,
    O_R,
    O_V,
    O_BA,
    O_BG,
)
