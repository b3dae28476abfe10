"""The port's numpy bootstrap (``lfvio_tpu_torch.vinit``) against the JAX
package's (``lfvio_tpu.vinit``): the same seeded numpy inputs, built as
``tests/test_vinit.py`` builds its cases, go through both.

Both are the same float64 numpy arithmetic, so results agree to 1e-12
(absolute; the tolerance only allows for a different BLAS call order, and
0 is what is seen).
"""

import numpy as np
import pytest

import lfvio_tpu.vinit as jv
import lfvio_tpu_torch.vinit as tv
from lfvio_tpu.vinit.alignment import AlignFrame as JAlignFrame
from lfvio_tpu_torch.geom import host as hg
from lfvio_tpu_torch.vinit.alignment import AlignFrame as TAlignFrame

TOL = 1e-12


def rot(axis_angle):
    return hg.quat_to_mat(hg.so3_exp(np.asarray(axis_angle, np.float64)))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0.0, atol=TOL)


def make_window(seed=2, n_frames=11, n_feat=80):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n_frames)
    p = np.stack([t, 0.3 * np.sin(2 * t), 0.15 * t], -1)
    theta = np.stack([0.1 * np.sin(2 * t), 0.12 * t, 0.2 * np.sin(t)], -1)
    Rw = np.stack([rot(th) for th in theta])  # world-from-cam
    dirs = rng.standard_normal((n_feat, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = p.mean(0) + dirs * rng.uniform(3, 8, (n_feat, 1))
    obs = {}
    for fid in range(n_feat):
        obs[fid] = []
        for fr in range(n_frames):
            pc = Rw[fr].T @ (pts[fid] - p[fr])
            obs[fid].append((fr, pc / np.linalg.norm(pc)))
    return p, Rw, pts, obs


def test_pnp_bearing_gn_parity():
    rng = np.random.default_rng(0)
    R_true = rot([0.2, -0.3, 0.4])
    t_true = np.array([0.5, -0.2, 0.3])
    pts = rng.standard_normal((60, 3)) * 5.0
    pc = pts @ R_true.T + t_true
    b = pc / np.linalg.norm(pc, axis=-1, keepdims=True)  # incl. negative z
    R0 = rot([0.25, -0.25, 0.35])
    t0 = t_true + [0.1, -0.05, 0.08]
    Rj, tj, okj = jv.pnp_bearing_gn(pts, b, R0, t0)
    Rt, tt, okt = tv.pnp_bearing_gn(pts, b, R0, t0)
    assert okj and okt
    close(Rt, Rj)
    close(tt, tj)
    np.testing.assert_allclose(Rt, R_true, atol=1e-8)


def test_solve_relative_rt_parity():
    rng = np.random.default_rng(1)
    R = rot([0.05, -0.08, 0.1])
    t = np.array([0.4, 0.1, -0.2])
    pts = rng.standard_normal((80, 3)) * 4.0 + [0, 0, 3.0]
    pts[::4, 2] = -pts[::4, 2]  # some behind
    b1 = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    p2 = pts @ R.T + t
    b2 = p2 / np.linalg.norm(p2, axis=-1, keepdims=True)
    out = rng.choice(80, 16, replace=False)  # 20% outliers
    fake = rng.standard_normal((16, 3))
    b2[out] = fake / np.linalg.norm(fake, axis=-1, keepdims=True)
    Rj, Tj, okj = jv.solve_relative_rt(b1, b2, rng=np.random.default_rng(7))
    Rt, Tt, okt = tv.solve_relative_rt(b1, b2, rng=np.random.default_rng(7))
    assert okj and okt
    close(Rt, Rj)
    close(Tt, Tj)
    np.testing.assert_allclose(Rt, R.T, atol=1e-4)


def test_global_sfm_parity():
    n = 11
    p, Rw, _, obs = make_window()
    R_rel = Rw[0].T @ Rw[n - 1]
    t_rel = Rw[0].T @ (p[n - 1] - p[0])
    t_rel = t_rel / np.linalg.norm(t_rel)
    okj, qj, Tj, ptsj = jv.global_sfm(n, 0, R_rel, t_rel, obs)
    okt, qt, Tt, ptst = tv.global_sfm(n, 0, R_rel, t_rel, obs)
    assert okj and okt
    close(qt, qj)
    close(Tt, Tj)
    assert ptst.keys() == ptsj.keys() and len(ptst) > 40
    for fid in ptsj:
        close(ptst[fid], ptsj[fid])


def _align_frames(frame_cls, seed=3, n_frames=11, frame_dt=0.1, s_true=2.7):
    """Frames of a trajectory with piecewise-constant world acceleration and
    body rate; the preintegrated deltas are the closed forms of that motion
    (exact for the position and velocity, first order in the bias Jacobian)."""
    G = np.array([0.0, 0.0, 9.81])
    rng = np.random.default_rng(seed)
    p, v = np.zeros(3), np.array([0.5, 0.0, 0.1])
    q = hg.so3_exp(np.array([0.05, -0.02, 0.1]))
    frames = [frame_cls(R=hg.quat_to_mat(q), T=p / s_true)]
    for _ in range(n_frames - 1):
        a_w = rng.standard_normal(3) * 0.8
        om = rng.standard_normal(3) * 0.3
        R0 = hg.quat_to_mat(q)
        p1 = p + v * frame_dt + 0.5 * a_w * frame_dt**2
        v1 = v + a_w * frame_dt
        q1 = hg.quat_mul(q, hg.so3_exp(om * frame_dt))
        fr = frame_cls(R=hg.quat_to_mat(q1), T=p1 / s_true)
        fr.sum_dt = frame_dt
        fr.delta_p = R0.T @ (p1 - p - v * frame_dt + 0.5 * G * frame_dt**2)
        fr.delta_v = R0.T @ (v1 - v + G * frame_dt)
        fr.delta_q = hg.so3_exp(om * frame_dt)
        fr.jac_q_bg = -frame_dt * np.eye(3)
        frames.append(fr)
        p, v, q = p1, v1, q1
    return frames, G, s_true


def test_visual_imu_alignment_parity():
    outs = []
    for mod, cls in ((jv, JAlignFrame), (tv, TAlignFrame)):
        frames, G, s_true = _align_frames(cls)
        outs.append(mod.visual_imu_alignment(
            frames, np.zeros(3), 9.81, repropagate_fn=lambda f, b: None))
    (okj, dbgj, gj, xj), (okt, dbgt, gt, xt) = outs
    assert okj and okt
    close(dbgt, dbgj)
    close(gt, gj)
    close(xt, xj)
    np.testing.assert_allclose(gt, G, atol=0.05)
    np.testing.assert_allclose(xt[-1], s_true, rtol=5e-3)


def test_ex_rotation_calibrator_parity():
    rng = np.random.default_rng(4)
    ric_true = rot([0.3, -0.5, 0.2])
    cj, ct = jv.ExtrinsicRotationCalibrator(), tv.ExtrinsicRotationCalibrator()
    for _ in range(12):
        R_imu = rot(rng.standard_normal(3) * 0.2)
        R_cam = ric_true.T @ R_imu @ ric_true
        q_imu = hg.mat_to_quat(R_imu)
        dj, rj = cj.add_rotation_pair(R_cam, q_imu)
        dt, rt = ct.add_rotation_pair(R_cam, q_imu)
        assert dj == dt
        close(rt, rj)
    assert dt
    np.testing.assert_allclose(rt, ric_true, atol=1e-6)


@pytest.mark.parametrize("name", ["sfm", "pnp", "relative", "ex_rotation", "alignment"])
def test_vinit_modules_are_the_ports_own(name):
    """Each module of the copy lives in the port and names nothing of the
    JAX package."""
    import importlib

    mod = importlib.import_module(f"lfvio_tpu_torch.vinit.{name}")
    src = open(mod.__file__).read()
    assert "lfvio_tpu_torch" in mod.__name__
    assert "import jax" not in src and "from lfvio_tpu" not in src and "import lfvio_tpu" not in src
