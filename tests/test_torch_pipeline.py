"""The port's slice as a whole against the JAX package, on the CPU in f64:
the synthetic world, the front end over a rendered sequence, the estimator
and pipeline over an analytic bearing stream, and the port's import chain
without JAX. The end-to-end accuracy gate of ``tests/test_e2e.py`` is
mirrored for the port as a ``slow`` test.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _bearing_harness import BearingFrontEnd, make_landmarks, run_bearing_stream

from lfvio_tpu.runtime.estimator import Estimator as JEstimator, EstimatorConfig as JConfig
from lfvio_tpu.runtime.synthetic import (
    SYN_MAX_R,
    SYN_MIN_R,
    SyntheticWorld as JWorld,
    make_synthetic_pal_camera as j_pal_camera,
)
from lfvio_tpu.runtime.tracker import FrontEnd as JFrontEnd

from lfvio_tpu_torch.runtime import synthetic as tsyn
from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu_torch.runtime.evaluation import ate_rmse
from lfvio_tpu_torch.runtime.pipeline import VioPipeline
from lfvio_tpu_torch.runtime.tracker import FrontEnd

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def worlds():
    return (JWorld(camera=j_pal_camera(dtype=jnp.float64)),
            tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                                device="cpu"))


def test_synthetic_world_parity(worlds):
    """Same seed, same world: frames within 1e-9 of 255, exact IMU, the
    same stream."""
    jw, tw = worlds
    for tt in (0.0, 0.37):
        np.testing.assert_allclose(tw.render(tt).numpy(), jw.render(tt), atol=1e-9)
        np.testing.assert_array_equal(tw.render_u8(tt).numpy(), jw.render_u8(tt))
    ts = np.linspace(0, 2, 41)
    for a, b in zip(tw.imu_batch(ts), jw.imu_batch(ts)):
        np.testing.assert_array_equal(a, b)
    sa, sb = tw.generate(1.0), jw.generate(1.0)
    assert [(e[0], e[1]) for e in sa] == [(e[0], e[1]) for e in sb]


def test_frontend_matches_jax_over_sequence(worlds):
    """Seven frames through both FrontEnds (test_e2e's configuration:
    160 slots, max_cnt 120, min_dist 15, refine window 15, no CLAHE) with
    the JAX key chain's RANSAC draws handed to the port. Ids and publish
    masks exactly equal; bearings within 1e-6 (the LK's float32 sampler on
    the JAX side, see test_plain_lk_parity); velocities (bearing change over
    1/15 s) within 1e-5."""
    jw, tw = worlds
    kw = dict(max_cnt=120, min_dist=15, n_slots=160, equalize=False,
              annulus=(jw.width / 2, jw.height / 2, SYN_MAX_R, SYN_MIN_R))
    jfe = JFrontEnd(jw.camera, (jw.height, jw.width), dtype=jnp.float64, **kw)
    tfe = FrontEnd(tw.camera, (jw.height, jw.width), dtype=F64, device="cpu", **kw)
    key = jax.random.PRNGKey(0)  # FrontEnd(seed=0)'s chain (tracker.py:226)
    n_pub = []
    for k in range(7):
        img = jw.render(k / 15.0)
        if k:
            key, sub = jax.random.split(key)
            u = np.asarray(jax.random.uniform(sub, (100, 160)))
            tfe.ransac_draws = lambda u=u: torch.as_tensor(u)
        jo = jfe.process_arrays(img, k / 15.0)
        to = tfe.process_arrays(img, k / 15.0)
        if k == 0:
            assert jo is None and to is None
            continue
        np.testing.assert_array_equal(to[0], jo[0])
        np.testing.assert_array_equal(to[4], jo[4])
        np.testing.assert_allclose(to[1], jo[1], atol=1e-6)
        np.testing.assert_allclose(to[2], jo[2], atol=1e-5)
        np.testing.assert_allclose(to[3], jo[3], atol=1e-3)
        n_pub.append(int(to[4].sum()))
    assert min(n_pub) > 60


def _port_bearing_stream(est, world, pts_w, duration, frame_rate, imu_rate=200.0):
    """run_bearing_stream's loop through the port's VioPipeline."""
    pipe = VioPipeline(BearingFrontEnd(world, pts_w, None, None), est)
    per_frame = int(round(imu_rate / frame_rate))
    ts = np.arange(int(duration * imu_rate) + 1) / imu_rate
    acc, om = world.imu_batch(ts)
    for k in range(len(ts)):
        if k % per_frame == 0:
            pipe.feed_frame(float(ts[k]), ts[k])
        pipe.feed_imu(float(ts[k]), acc[k], om[k])
    pipe.flush()
    return pipe


def test_estimator_pipeline_matches_jax(worlds):
    """One analytic bearing stream (48 landmarks, 20 Hz, 1.5 s) through the
    JAX pipeline (tests/_bearing_harness.py::run_bearing_stream) and the
    port's: both initialize on the same frame and their trajectories
    differ by at most 1 mm (f64 on both sides)."""
    jw, _ = worlds
    pts = make_landmarks()
    jest = JEstimator(JConfig(n_feature_slots=64, solver_dtype=jnp.float64))
    run_bearing_stream(jest, jw, pts, duration=1.5, frame_rate=20.0)
    test = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, device="cpu"))
    pipe = _port_bearing_stream(test, jw, pts, duration=1.5, frame_rate=20.0)
    assert test.solver_flag == test.NON_LINEAR == jest.solver_flag
    assert len(test.times) == len(jest.times) > 15
    np.testing.assert_array_equal(test.times, jest.times)
    assert np.abs(np.asarray(test.traj_p) - np.asarray(jest.traj_p)).max() <= 1e-3
    assert len(pipe.high_rate) > 100


def test_restart_on_stream_gap(worlds):
    """A frame more than 1 s after the last one restarts the front end and
    the estimator (feature_tracker_node.cpp:38-48), and the stream goes on."""
    jw, _ = worlds
    est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, device="cpu"))
    fe = BearingFrontEnd(jw, make_landmarks(), None, None)
    pipe = VioPipeline(fe, est)
    ts = np.arange(0, 2.0, 0.005)
    acc, om = jw.imu_batch(ts)
    for k, tt in enumerate(ts):
        if k % 10 == 0 and not 0.3 < tt < 1.6:
            pipe.feed_frame(float(tt), tt)
        pipe.feed_imu(float(tt), acc[k], om[k])
    pipe.flush()
    assert pipe.n_restarts == 1 and fe.n_resets == 1
    assert est.frame_count > 0 and est.headers[0] >= 1.6


def test_trajectory_io_roundtrip(tmp_path):
    from lfvio_tpu_torch.runtime.trajectory_io import read_tum, write_tum

    rng = np.random.default_rng(0)
    t_ = np.arange(5) * 0.1
    p = rng.standard_normal((5, 3))
    q = rng.standard_normal((5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    write_tum(tmp_path / "traj.txt", t_, p, q)
    t2, p2, q2 = read_tum(tmp_path / "traj.txt")
    np.testing.assert_allclose(t2, t_, atol=1e-9)
    np.testing.assert_allclose(p2, p, atol=1e-9)
    np.testing.assert_allclose(q2, q, atol=1e-9)


def test_port_imports_and_runs_without_jax():
    """With JAX made unimportable, the port imports (calib, dist, native and
    the runtime tools included) and runs three frames of its FrontEnd, one
    lm_solve and make_window_problem on the CPU."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        import lfvio_tpu_torch, lfvio_tpu_torch.convert
        from lfvio_tpu_torch.runtime import synthetic, FrontEnd, Estimator, VioPipeline
        from lfvio_tpu_torch.frontend import klt_cuda
        from lfvio_tpu_torch.backend import (FeatureGrid, PriorFactor, SolverConfig,
                                             WindowState, lm_solve)
        from lfvio_tpu_torch.imu import ImuNoise, preintegrate, whiten_covariance
        from lfvio_tpu_torch import calib, dist, native
        from lfvio_tpu_torch.runtime import ar_demo, datasets, panorama, profiling
        assert profiling.make_window_problem(8, device="cpu")["grid"].valid.shape == (8, 11)
        w = synthetic.SyntheticWorld(camera=synthetic.make_synthetic_pal_camera(256, 192),
                                     width=256, height=192, device="cpu")
        fe = FrontEnd(w.camera, (192, 256), max_cnt=40, min_dist=10, n_slots=48,
                      annulus=(128, 96, 95, 32), device="cpu")
        outs = [fe.process_arrays(w.render(k / 15), k / 15) for k in range(3)]
        assert outs[0] is None and outs[2][4].sum() > 10
        rng = np.random.default_rng(0)
        Fn, W1 = 16, 11
        b = rng.standard_normal((Fn, W1, 3)); b /= np.linalg.norm(b, axis=-1, keepdims=True)
        grid = FeatureGrid(torch.tensor(b), torch.zeros(Fn, W1, 3), torch.zeros(Fn, W1),
                           torch.ones(Fn, W1, dtype=torch.bool), torch.zeros(Fn, dtype=torch.long),
                           torch.ones(Fn, dtype=torch.bool))
        st = WindowState.zeros(Fn, torch.float64)
        st = st.replace(p=torch.linspace(0, 1, W1, dtype=torch.float64)[:, None].repeat(1, 3))
        z = torch.zeros(10, 3, dtype=torch.float64)
        acc = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64).repeat(10, 4, 1)
        pre = preintegrate(torch.full((10, 4), 0.025, dtype=torch.float64), acc,
                           torch.zeros(10, 4, 3, dtype=torch.float64), acc[:, 0], z, z, z,
                           ImuNoise(0.02, 0.01, 0.04, 0.001))
        si, iv = whiten_covariance(pre.covariance, torch.ones(10, dtype=torch.bool))
        out, c0, c1, _ = lm_solve(st, grid, pre, si, iv, PriorFactor.empty(torch.float64),
                                  torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64),
                                  SolverConfig(max_iterations=2))
        assert torch.isfinite(out.p).all() and float(c1) <= float(c0)
        assert klt_cuda.lk_level.launches == 0
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_port_imports_nothing_of_the_jax_package():
    """In a fresh process, importing the port, every submodule of it and
    chip_smoke (as a module) loads neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import lfvio_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(lfvio_tpu_torch.__path__,
                                                       "lfvio_tpu_torch.")]
        assert "lfvio_tpu_torch.vinit.sfm" in names and len(names) > 30, names
        for new in ("backend.relo", "runtime.config", "runtime.checkpoint", "calib.chessboard",
                    "calib.intrinsic", "dist.sharding", "dist.marginalize", "dist.frame_step",
                    "native", "runtime.datasets", "runtime.panorama", "runtime.ar_demo",
                    "runtime.profiling", "dist.kf_axis", "dist.synthetic_traj",
                    "dist.scaling_bench"):
            assert "lfvio_tpu_torch." + new in names, new
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "lfvio_tpu")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def _build_frontend(**kw):
    cam = tsyn.make_synthetic_pal_camera(256, 192)
    return FrontEnd(cam, (192, 256), annulus=(128, 96, 95, 32), n_slots=48, **kw)


def _build_dual(**kw):
    from lfvio_tpu_torch.runtime.tracker import DualFrontEnd

    return DualFrontEnd(_build_frontend(**kw), _build_frontend(seed=1, **kw))


_PINHOLE_RIG = """%YAML:1.0
model_type: PINHOLE
image_width: 256
image_height: 192
projection_parameters:
   fx: 200.0
   fy: 200.0
   cx: 128.0
   cy: 96.0
"""


def _rig():
    from lfvio_tpu_torch.runtime.config import load_rig_yaml

    return load_rig_yaml(_PINHOLE_RIG)


def _build_from_yaml(tmp_path, **kw):
    path = tmp_path / "rig.yaml"
    path.write_text(_PINHOLE_RIG)
    return VioPipeline.from_yaml(str(path), n_slots=32, **kw).est


def _build_from_checkpoint(tmp_path, **kw):
    from lfvio_tpu_torch import convert
    from lfvio_tpu_torch.runtime.checkpoint import save_checkpoint

    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, Estimator(EstimatorConfig(n_feature_slots=16, device="cpu")))
    return convert.estimator_from_checkpoint(path, n_feature_slots=16, **kw)


@pytest.mark.parametrize("build", [
    lambda tmp, **kw: _build_frontend(**kw),
    lambda tmp, **kw: Estimator(EstimatorConfig(n_feature_slots=64, **kw)),
    lambda tmp, **kw: tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(256, 192),
                                          width=256, height=192, **kw),
    lambda tmp, **kw: _build_dual(**kw),
    lambda tmp, **kw: _rig().make_frontend(n_slots=32, **kw),
    lambda tmp, **kw: _rig().make_estimator(n_slots=32, **kw),
    lambda tmp, **kw: _rig().make_pipeline(n_slots=32, **kw).fe,
    _build_from_yaml,
    _build_from_checkpoint,
], ids=["FrontEnd", "Estimator", "SyntheticWorld", "DualFrontEnd", "RigConfig.make_frontend",
        "RigConfig.make_estimator", "RigConfig.make_pipeline", "VioPipeline.from_yaml",
        "load_checkpoint"])
def test_entry_points_default_to_the_card(build, tmp_path):
    """Built without a device an entry point lands on the CUDA card, and
    raises where there is none (no quiet step down to the CPU); built with
    device="cpu" it runs on the CPU."""
    assert build(tmp_path, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert build(tmp_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(tmp_path)


@pytest.mark.slow
def test_port_e2e_vio_ate():
    """tests/test_e2e.py::test_e2e_vio_ate for the port on the CPU: f32
    tracker, f64 solver, 7 s; initialization succeeds and ATE < 0.25 m."""
    world = tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                                device="cpu")
    fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                  n_slots=160, equalize=False, dtype=torch.float32, device="cpu",
                  annulus=(world.width / 2, world.height / 2, SYN_MAX_R, SYN_MIN_R))
    est = Estimator(EstimatorConfig(n_feature_slots=256, solver_dtype=F64, device="cpu"))
    times, traj_p, _ = VioPipeline(fe, est).run(
        world.generate(7.0, 15.0, 200.0), lambda tt: world.render(tt))
    assert est.solver_flag == est.NON_LINEAR
    assert len(times) > 35
    gt_p = np.stack([world.pose(tt)[0] for tt in times])
    ate, _ = ate_rmse(times, traj_p, times, gt_p)
    assert np.isfinite(ate) and ate < 0.25, ate
