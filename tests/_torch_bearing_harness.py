"""The port's bearing-level harness (``chip_smoke.py``'s, a copy of
``tests/_bearing_harness.py`` that imports no JAX), usable with either
package's pipeline: a stub front end serves analytic bearings of known
landmarks and exact IMU goes through the real measurement-alignment path,
so a stream isolates the back end. ``run_both`` drives one named stream
through the JAX pipeline and the port's (on the CPU, f64) and caches the
pair. Its JAX estimator marginalizes with the JAX package's eigh forms
(``eigh_marginalizing``), or where a stream says so with the JAX QR form
given the port's unit rows (``qr_unit_rows_marginalizing``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import (  # noqa: F401  (re-exported to the test files)
    BearingFrontEnd,
    cam_bearings,
    make_landmarks,
    run_bearing_stream as run_stream,
)
from lfvio_tpu.backend import factors as jfactors
from lfvio_tpu.backend import marginalize as jmarg
from lfvio_tpu.backend import solver as jsolver
from lfvio_tpu.backend import state as jb_state
from lfvio_tpu.runtime.estimator import Estimator as JEstimator, EstimatorConfig as JConfig
from lfvio_tpu.runtime.pipeline import VioPipeline as JPipeline
from lfvio_tpu.runtime.synthetic import SyntheticWorld as JWorld, make_synthetic_pal_camera as j_cam

from lfvio_tpu_torch.runtime import synthetic as tsyn
from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu_torch.runtime.pipeline import VioPipeline

F64 = torch.float64


class DispatchingBearingFrontEnd(BearingFrontEnd):
    """The same stub behind the dispatch / finalize interface, so that the
    pipelines run their depth-N path (in-flight and deferred frame queues)."""

    def dispatch(self, img, t, publish=True):
        return ("stub", None, (np.zeros(1),), t, publish)

    def finalize(self, handle, host_outs=None):
        return self.process_arrays(None, handle[3], handle[4])


def make_worlds():
    return (JWorld(camera=j_cam(dtype=jnp.float64)),
            tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                                device="cpu"))


def eigh_marginalizing(jest):
    """The JAX estimator ``jest`` with its marginalization programs replaced
    by jax.jit of the JAX package's eigh forms (``marginalize_old``,
    ``marginalize_second_new``: the reference's own H-space elimination),
    bound to the estimator's gravity and SolverConfig. The port's QR forms
    lose no information where a dropped column is empty and so equal them;
    the JAX QR forms drop information there. ``jest.second_news`` counts
    the SECOND_NEW marginalizations (the streams at the default parallax
    take none: every frame is a keyframe). Needs a float64 estimator."""
    gravity = jnp.asarray([0.0, 0.0, jest.cfg.g_norm], jest.cfg.solver_dtype)
    jest._marg_old = jax.jit(lambda out, grid, pre, si, iv, prior: jmarg.marginalize_old(
        out, grid, pre, si, iv, prior, gravity, jest.scfg))
    marg_new = jax.jit(lambda out, prior: jmarg.marginalize_second_new(out, prior, jest.scfg))
    jest.second_news = 0

    def counted_marg_new(out, prior):
        jest.second_news += 1
        return marg_new(out, prior)

    jest._marg_new = counted_marg_new
    return jest


def _with_unit_rows(A, m):
    """backend/marginalize.py::_with_unit_rows in JAX: m rows appended, row i
    the unit row of column i where that column of A is all zero."""
    empty = jnp.all(A[:, :m] == 0, axis=0)
    unit = jnp.concatenate([jnp.diag(empty.astype(A.dtype)),
                            jnp.zeros((m, A.shape[1] - m), A.dtype)], axis=1)
    return jnp.concatenate([A, unit], axis=0)


def jax_marginalize_old_qr_unit_rows(state, grid, pre0, sqrt_info_imu0, imu0_valid, prior,
                                     gravity, cfg):
    """The JAX package's marginalize_old_qr (lfvio_tpu/backend/marginalize.py:
    the same pieces in the same order) with the port's unit rows in the
    empty dropped columns."""
    n_frames = state.p.shape[0]
    F, W1 = grid.valid.shape
    D = jb_state.pose_dim(n_frames, jb_state.n_cams_of(state))
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    imu_valid = jnp.zeros_like(imu0_valid).at[0].set(imu0_valid[0])
    res_w, Jfull, J_lam, _, _ = jsolver.linearize_proj_rows(state, grid0, cfg)
    imu_res, Jimu, _ = jsolver.linearize_imu_rows(state, pre0, sqrt_info_imu0, imu_valid,
                                                  gravity)
    rp = jfactors.prior_residual(state, prior)
    Jp = jnp.where(prior.valid, prior.J, jnp.zeros_like(prior.J))
    R1 = F * W1 * 2
    dep_rows = jnp.einsum("fja,fg->fjag", J_lam, jnp.eye(F, dtype=Jp.dtype)).reshape(R1, F)
    A_pose = jnp.concatenate([Jfull.reshape(R1, D), Jimu, Jp], axis=0)
    A_dep = jnp.concatenate([dep_rows, jnp.zeros((A_pose.shape[0] - R1, F), Jp.dtype)], axis=0)
    r = jnp.concatenate([res_w.reshape(R1), imu_res.reshape(-1), rp])
    drop, keep = jmarg._keep_drop_indices(n_frames, D)
    A = jnp.concatenate([A_pose[:, drop], A_dep, A_pose[:, keep], r[:, None]], axis=1)
    m, K = len(drop) + F, len(keep)
    Rfac = jnp.linalg.qr(_with_unit_rows(A, m), mode="r")
    Jk, rk = Rfac[m:m + K, m:m + K], Rfac[m:m + K, m + K]
    ok = jnp.isfinite(Jk).all() & jnp.isfinite(rk).all()
    J = jnp.zeros((D, D), Jp.dtype).at[jnp.ix_(keep, keep)].set(jnp.where(ok, Jk, 0.0))
    r0 = jnp.zeros((D,), Jp.dtype).at[keep].set(jnp.where(ok, rk, 0.0))
    J, r0 = jmarg._shift_prior_blocks(J, r0, n_frames)
    new_prior = jb_state.PriorFactor.from_state(J, r0, jmarg._shift_state_snapshot(state))
    return dataclasses.replace(new_prior, valid=ok)


def qr_unit_rows_marginalizing(jest):
    """The JAX estimator ``jest`` with its MARGIN_OLD program replaced by
    jax.jit of ``jax_marginalize_old_qr_unit_rows``, for a stream whose
    port run cannot meet its bound against ``eigh_marginalizing``. The eigh
    square root zeroes the prior's eigenvalues below 1e-10 of the largest,
    which QR keeps: on the td stream that moves JᵀJ by up to 5.6e-7 of its
    scale at a MARGIN_OLD (inside tests/test_marg_qr.py's 2e-6), and the
    trajectories 7.9e-6 m apart over the stream."""
    gravity = jnp.asarray([0.0, 0.0, jest.cfg.g_norm], jest.cfg.solver_dtype)
    jest._marg_old = jax.jit(lambda out, grid, pre, si, iv, prior: (
        jax_marginalize_old_qr_unit_rows(out, grid, pre, si, iv, prior, gravity, jest.scfg)))
    return jest


# ------------------------------------------------------------------ streams
STREAMS = {
    "lag1": dict(cfg=dict(solve_lag=1)),
    "lag2_chain": dict(cfg=dict(solve_lag=2, device_chain=True)),
    "lag2_mirrors": dict(cfg=dict(solve_lag=2, device_chain=False)),
    "lag3": dict(cfg=dict(solve_lag=3)),
    # chip_smoke.py phase 7's lag-3 stream: at 30 px of keyframe parallax
    # the window merges non-keyframes (SECOND_NEW) between keyframes.
    "lag3_second_new": dict(cfg=dict(solve_lag=3, min_parallax=30.0 / 160.0), traj_freq=0.5,
                            duration=2.2),
    "td": dict(cfg=dict(solve_lag=1, estimate_td=True), td_true=0.005, traj_freq=0.8,
               reference=qr_unit_rows_marginalizing),
    "depth3_throttled": dict(cfg=dict(solve_lag=2), dispatching=True, freq=10.0, duration=2.6),
    # A wall budget that binds from the first solve: the same fixed time per
    # LM iteration on both estimators (the pipelines calibrate only without
    # one), so the cap is 3, 2 when marginalizing old (0.8 of the budget).
    "budget": dict(cfg=dict(solve_lag=1, max_solver_time=0.035), iter_time=0.01),
}
_runs = {}


def run_both(key, worlds):
    """The stream ``key`` through the JAX pipeline and the port's (cached)."""
    if key in _runs:
        return _runs[key]
    spec = STREAMS[key]
    jw, tw = worlds
    if "traj_freq" in spec:
        jw = JWorld(camera=jw.camera, traj_freq=spec["traj_freq"])
        tw = tsyn.SyntheticWorld(camera=tw.camera, traj_freq=spec["traj_freq"], dtype=F64,
                                 device="cpu")
    pts = make_landmarks()
    fe_cls = DispatchingBearingFrontEnd if spec.get("dispatching") else BearingFrontEnd
    pkw = dict(freq=spec.get("freq", 0.0))
    jest = spec.get("reference", eigh_marginalizing)(
        JEstimator(JConfig(n_feature_slots=64, solver_dtype=jnp.float64, **spec["cfg"])))
    test = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, device="cpu",
                                     **spec["cfg"]))
    if "iter_time" in spec:
        jest._iter_time = test._iter_time = spec["iter_time"]
    dur = spec.get("duration", 1.5)
    jp = run_stream(JPipeline(fe_cls(jw, pts, td_true=spec.get("td_true", 0.0)), jest, **pkw),
                    jw, dur)
    tp = run_stream(VioPipeline(fe_cls(tw, pts, td_true=spec.get("td_true", 0.0)), test, **pkw),
                    tw, dur)
    _runs[key] = (jest, test, jp, tp, jw, tw, pts)
    return _runs[key]


