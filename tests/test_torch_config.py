"""The port's camera models, rig YAML, checkpoints, synthetic-world extras
and ``convert`` against the JAX package, on the CPU in f64.

Camera lift and projection: 1e-10 (the same fixed iteration counts on both
sides). A checkpoint written by the JAX package is resumed in the port and
the next frames' solves are compared (1e-6 m, as the streams of
``tests/test_torch_estimator.py``).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lfvio_tpu.cam import models as jcam
from lfvio_tpu.runtime import checkpoint as jckpt
from lfvio_tpu.runtime import config as jconfig
from lfvio_tpu.runtime.estimator import Estimator as JEstimator, EstimatorConfig as JConfig

from lfvio_tpu_torch import convert
from lfvio_tpu_torch.cam import models as tcam
from lfvio_tpu_torch.runtime import checkpoint as tckpt
from lfvio_tpu_torch.runtime import config as tconfig
from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu_torch.runtime.pipeline import VioPipeline

from _torch_bearing_harness import make_worlds, run_both, run_stream
from test_config import RIG_YAML

F64 = torch.float64

CAMERA_CFGS = {
    "PinholeCamera": dict(
        model_type="PINHOLE",
        projection_parameters=dict(fx=461.6, fy=460.3, cx=363.0, cy=248.1),
        distortion_parameters=dict(k1=-0.2917, k2=0.08228, p1=5.333e-05, p2=-1.578e-04)),
    "KannalaBrandtCamera": dict(
        model_type="KANNALA_BRANDT",
        projection_parameters=dict(mu=190.9, mv=190.9, u0=254.9, v0=256.9,
                                   k2=0.0034, k3=0.0007, k4=-0.0021, k5=0.0002)),
    "MeiCamera": dict(
        model_type="MEI", mirror_parameters=dict(xi=1.2),
        distortion_parameters=dict(k1=-0.11, k2=0.06, p1=1e-3, p2=-2e-3),
        projection_parameters=dict(gamma1=700.0, gamma2=705.0, u0=320.0, v0=240.0)),
}


@pytest.mark.parametrize("name", list(CAMERA_CFGS))
def test_camera_models_match_jax(name):
    """camera_from_dict dispatches to the same model; lift_projective,
    lift_sphere and space_to_plane within 1e-10; lift then project returns
    the pixel; ``convert.camera`` carries the JAX parameters over."""
    cfg = CAMERA_CFGS[name]
    jc = jcam.camera_from_dict(cfg, dtype=jnp.float64)
    tc = tcam.camera_from_dict(cfg, dtype=F64, device="cpu")
    assert type(jc).__name__ == type(tc).__name__ == name
    rng = np.random.default_rng(1)
    px = np.stack([rng.uniform(60, 600, 200), rng.uniform(40, 440, 200)], -1)
    jl = np.asarray(jc.lift_projective(jnp.asarray(px)))
    tl = tc.lift_projective(torch.as_tensor(px))
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-10, rtol=0)
    np.testing.assert_allclose(tc.lift_sphere(torch.as_tensor(px)).numpy(),
                               np.asarray(jc.lift_sphere(jnp.asarray(px))), atol=1e-10, rtol=0)
    P = jl * rng.uniform(0.5, 4.0, (200, 1))
    jp = np.asarray(jc.space_to_plane(jnp.asarray(P)))
    np.testing.assert_allclose(tc.space_to_plane(torch.as_tensor(P)).numpy(), jp,
                               atol=1e-10, rtol=0)
    np.testing.assert_allclose(jp, px, atol=1e-4)
    fields = {f.name: np.asarray(getattr(jc, f.name)) for f in dataclasses.fields(jc)}
    tc2 = convert.camera(fields, model=name)
    assert torch.equal(tc2.lift_projective(torch.as_tensor(px)), tl)
    assert tc.to(dtype=torch.float32).lift_projective(torch.as_tensor(px[:3]).float()).dtype \
        == torch.float32


def test_unknown_camera_model_raises():
    with pytest.raises(ValueError, match="unknown camera model_type"):
        tcam.camera_from_dict(dict(model_type="ortho"), device="cpu")


def test_load_rig_yaml_field_for_field():
    jr, tr = jconfig.load_rig_yaml(RIG_YAML), tconfig.load_rig_yaml(RIG_YAML)
    assert [f.name for f in dataclasses.fields(jr)] == [f.name for f in dataclasses.fields(tr)]
    for f in dataclasses.fields(jr):
        a, b = getattr(jr, f.name), getattr(tr, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b), f.name
    assert tr.max_cnt == 150 and tr.td == -0.008 and tr.annulus == (256.0, 192.0, 190.0, 64.0)
    # Defaults where the file is silent, and estimate_extrinsic: 2 drops the
    # file's extrinsics.
    text = "%YAML:1.0\nmodel_type: PINHOLE\nestimate_extrinsic: 2\n" \
           "projection_parameters:\n   fx: 400.0\n   fy: 400.0\n   cx: 320.0\n   cy: 240.0\n"
    jr2, tr2 = jconfig.load_rig_yaml(text), tconfig.load_rig_yaml(text)
    for f in dataclasses.fields(jr2):
        a, b = getattr(jr2, f.name), getattr(tr2, f.name)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, f.name
    assert tr2.max_solver_time == 0.04 and tr2.annulus is None


def test_pipeline_from_yaml(tmp_path):
    """One YAML builds the whole pipeline like the JAX package's, and a
    model without an annulus builds a FrontEnd with a full mask."""
    path = tmp_path / "rig.yaml"
    path.write_text(RIG_YAML)
    pipe = VioPipeline.from_yaml(str(path), n_slots=64, device="cpu")
    from lfvio_tpu.runtime.pipeline import VioPipeline as JPipeline

    jpipe = JPipeline.from_yaml(str(path), n_slots=64)
    assert isinstance(pipe.fe.camera, tcam.ScaramuzzaCamera)
    assert (pipe.fe.max_cnt, pipe.fe.min_dist, pipe.fe.N) == (150, 18, 64)
    assert pipe.freq == jpipe.freq == 10.0 and pipe.td == jpipe.td == -0.008
    assert pipe.depth == jpipe.depth == 3
    for name in ("n_feature_slots", "min_parallax", "g_norm", "estimate_td",
                 "estimate_extrinsic", "calib_extrinsic_rotation", "td0", "max_iterations",
                 "max_solver_time", "rolling_shutter_tr", "image_rows", "window", "solve_lag"):
        assert getattr(pipe.est.cfg, name) == getattr(jpipe.est.cfg, name), name
    np.testing.assert_array_equal(pipe.est.tic, jpipe.est.tic)
    np.testing.assert_allclose(pipe.est.qic, jpipe.est.qic, atol=1e-15)
    assert pipe.est.td == -0.008 and pipe.est.device == torch.device("cpu")
    np.testing.assert_array_equal(pipe.fe.static_mask.numpy(), np.asarray(jpipe.fe.static_mask))
    rig = tconfig.load_rig_yaml(RIG_YAML)
    rig.annulus = None
    rig.camera_cfg = CAMERA_CFGS["PinholeCamera"]
    fe = rig.make_frontend(n_slots=32, device="cpu")
    assert isinstance(fe.camera, tcam.PinholeCamera) and bool(fe.static_mask.all())


def test_pipeline_td_seeds_the_estimator():
    """VioPipeline(td=...) sets the estimator's live camera-IMU offset, at
    construction and again after a restart; without it the estimator keeps
    its own cfg.td0."""

    class NoFrontEnd:
        def reset(self):
            pass

    est = Estimator(EstimatorConfig(n_feature_slots=8, td0=-0.008, device="cpu"))
    pipe = VioPipeline(NoFrontEnd(), est)
    assert pipe.td is None and est.td == pipe._td_now == -0.008
    pipe = VioPipeline(NoFrontEnd(), est, td=0.004)
    assert est.td == pipe._td_now == 0.004
    est.td = 0.1  # as a solve with estimate_td moves it
    assert pipe._td_now == 0.1
    pipe.restart()
    assert est.td == 0.004 and pipe.n_restarts == 1


def test_synthetic_world_extras_match_jax():
    jw, tw = make_worlds()
    ts = np.linspace(0.0, 3.0, 17)
    for a, b in zip(jw.pose_batch(ts), tw.pose_batch(ts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jw.velocity(0.7), tw.velocity(0.7))
    for a, b in zip(jw.imu_sample(0.7), tw.imu_sample(0.7)):
        np.testing.assert_array_equal(a, b)
    ric, tic = np.diag([1.0, -1.0, -1.0]), np.array([0.0, 0.0, -0.05])
    np.testing.assert_allclose(tw.render_rig(0.4, ric, tic).numpy(), jw.render_rig(0.4, ric, tic),
                               atol=1e-9)


def test_checkpoint_roundtrip_and_key_parity(tmp_path):
    """The port's save → load round trip, and the same .npz keys as the JAX
    package's file for the same estimator state."""
    rng = np.random.default_rng(0)
    ests = [JEstimator(JConfig(n_feature_slots=16, n_cams=2, solver_dtype=jnp.float64)),
            Estimator(EstimatorConfig(n_feature_slots=16, n_cams=2, solver_dtype=F64,
                                      device="cpu"))]
    Ps, Vs = rng.standard_normal((11, 3)), rng.standard_normal((11, 3))
    buf = [(0.005, rng.standard_normal(3), rng.standard_normal(3)) for _ in range(7)]
    for est in ests:
        est.Ps[:], est.Vs[:] = Ps, Vs
        est.solver_flag, est.frame_count = est.NON_LINEAR, 10
        est.gravity = np.array([0, 0, 9.81])
        est.imu_buf[3] = list(buf)
        est.fm.feature_id[:5] = np.arange(5)
        est.fm.valid[:5, 2:7] = True
        est.fm.depth[:5] = 4.2
        est.fm.cam[:5, 2:7] = np.tile([0, 1, 1, 0, 1], (5, 1))
    ests[1].prior = ests[1]._empty_prior()
    ests[0].prior = ests[0]._empty_prior()
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), ests[0])
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), ests[1])
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    assert tckpt.PRIOR_FIELDS == jckpt.PRIOR_FIELDS
    for k in zj.files:
        assert zj[k].shape == zt[k].shape, k
        np.testing.assert_allclose(zt[k].astype(np.float64), zj[k].astype(np.float64),
                                   atol=1e-15, err_msg=k)
    est2 = convert.estimator_from_checkpoint(
        str(tmp_path / "t.npz"), n_feature_slots=16, n_cams=2, solver_dtype=F64, device="cpu")
    np.testing.assert_array_equal(est2.Ps, Ps)
    assert est2.solver_flag == est2.NON_LINEAR and est2.frame_count == 10
    assert len(est2.imu_buf[3]) == 7
    np.testing.assert_array_equal(est2.imu_buf[3][2][1], buf[2][1])
    np.testing.assert_array_equal(est2.fm.cam[:5, 2:7], ests[1].fm.cam[:5, 2:7])
    assert est2.fm._id2slot == {i: i for i in range(5)}
    assert est2.prior.J.shape == (178, 178) and est2.prior.valid.dtype == torch.bool


def test_resume_from_a_jax_checkpoint(tmp_path):
    """A running JAX estimator's state, saved by the JAX package, resumed in
    the port (estimator_from_checkpoint): the next 0.3 s of the stream
    solved by both, trajectories within 1e-6 m."""
    worlds = make_worlds()
    jest, _, jp, _, jw, tw, pts = run_both("lag1", worlds)
    n0 = len(jest.times)
    path = str(tmp_path / "running.npz")
    jckpt.save_checkpoint(path, jest)
    test = convert.estimator_from_checkpoint(path, n_feature_slots=64, solver_dtype=F64,
                                             device="cpu")
    assert test.prior is not None and bool(test.prior.valid)
    np.testing.assert_array_equal(test.Ps, jest.Ps)
    from _torch_bearing_harness import BearingFrontEnd

    tp = VioPipeline(BearingFrontEnd(tw, pts), test)
    tp._last_imu, tp._last_frame_t = jp._last_imu, jp._last_frame_t
    run_stream(jp, jw, 0.3, t0=1.5)
    run_stream(tp, tw, 0.3, t0=1.5)
    new_j = np.asarray(jest.traj_p)[n0:]
    assert len(test.times) == len(new_j) >= 5
    np.testing.assert_array_equal(test.times, jest.times[n0:])
    assert np.abs(np.asarray(test.traj_p) - new_j).max() <= 1e-6
    assert np.abs(test.Ps - jest.Ps).max() <= 1e-6
