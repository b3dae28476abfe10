"""The benchmark's world is periodic: pose, IMU and frame at t and t + P
agree, so a replay may reuse one period's frames; the settling envelope's
IMU is the derivative of its trajectory."""

import json

import numpy as np
import pytest
import torch

from vio_bench.traffic import Replay
from vio_bench.world import Trajectory

from conftest import REPO, write_tiny


def _traffic(name):
    return json.loads((REPO / "vio_bench/traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["kf_replay", "hover_replay"])
def test_pose_and_imu_repeat_after_a_period(name):
    traj = Trajectory(_traffic(name))
    t = traj.steady_from + np.linspace(0.0, 40.0, 97)
    for a, b in zip(traj.pose(t), traj.pose(t + traj.period)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    for a, b in zip(traj.imu(t, 9.81), traj.imu(t + 3 * traj.period, 9.81)):
        np.testing.assert_allclose(a, b, atol=1e-8)


@pytest.mark.parametrize("name", ["kf_replay", "hover_replay"])
def test_imu_is_the_trajectorys_derivative(name):
    """Velocity by central differences of p, then acceleration; the body rate
    from the rotation over a short step."""
    traj = Trajectory(_traffic(name))
    t = np.linspace(0.5, 8.0, 31)
    h = 1e-4
    a_fd = (traj.pose(t + h)[0] - 2 * traj.pose(t)[0] + traj.pose(t - h)[0]) / h**2
    acc, om = traj.imu(t, 9.81)
    from vio_bench.world import quat_to_mat, so3_exp

    R = quat_to_mat(traj.pose(t)[1])
    np.testing.assert_allclose(np.einsum("nij,nj->ni", R, acc) - [0, 0, 9.81], a_fd, atol=1e-4)
    R1 = quat_to_mat(traj.pose(t + h)[1])
    dR = np.einsum("nji,njk->nik", R, R1)  # Rᵀ R(t+h) ≈ I + [ω h]×
    w_fd = np.stack([dR[:, 2, 1], dR[:, 0, 2], dR[:, 1, 0]], 1) / h
    np.testing.assert_allclose(om, w_fd, atol=1e-3)


def test_settle_scales_the_motion_down():
    tr = _traffic("hover_replay")
    traj = Trajectory(tr)
    s = tr["settle"]
    late = traj.steady_from + np.linspace(0, traj.period, 400)
    early = np.linspace(0, s["start_s"], 400)
    full = np.abs(traj.pose(early)[0]).max(0)
    small = np.abs(traj.pose(late)[0]).max(0)
    assert np.all(small <= s["pos_scale"] * np.asarray(tr["pos_amp_m"]) + 1e-12)
    assert np.all(full > 0.5 * small / s["pos_scale"])


def test_frames_repeat_after_a_period(tmp_path):
    """Frame k and frame k + n (n frames a period) render to the same image,
    and the replay hands the second the first's image."""
    root = write_tiny(tmp_path)
    cfg = json.loads((root / "vio_bench/configs/tiny.json").read_text())
    tr = json.loads((root / "vio_bench/traffic/tiny_kf.json").read_text())
    rp = Replay(cfg, tr, seed=5, device="cpu")
    n = rp.n_period
    assert n == round(tr["period_s"] * cfg["frame_rate"])
    for k in (3, 17):
        again = rp.world.render_u8([rp.frame_time(k + n)])[0]
        assert torch.equal(again, rp.images[rp.image_index(k)])
        assert rp.image_index(k + n) == rp.image_index(k)
    j = 7
    for a, b in zip(rp.imu(j), rp.imu(j + rp.n_imu_period)):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_events_are_in_time_order():
    tr = _traffic("kf_replay")
    cfg = json.loads((REPO / "vio_bench/configs/pal_mindvision.json").read_text())
    cfg["camera"].update(width=64, height=48)
    rp = Replay(cfg, tr, seed=1, device="cpu")
    ev = rp.events()
    ts = [next(ev)[1] for _ in range(2000)]
    assert all(b > a for a, b in zip(ts, ts[1:]))
