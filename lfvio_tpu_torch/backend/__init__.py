from .state import WindowState, FeatureGrid, PriorFactor, SolverConfig
from .factors import (
    projection_residuals_grid,
    imu_residuals_window,
    prior_residual,
    cauchy_corrector,
)
from .solver import assemble_normal_equations, lm_solve, apply_delta
from .marginalize import (
    marginalize_old,
    marginalize_old_qr,
    marginalize_second_new,
    marginalize_second_new_qr,
)
from .gauge import yaw_gauge_fix
from .relo import lm_solve_relo
from .triangulate import triangulate_grid
