"""The port's dataset readers (``lfvio_tpu_torch.runtime.datasets``).

Exact cases: the port's own PNG decoder gives the bytes ``cv2.imread`` gives
(greyscale) on images written with each of the five row filters; the CSV
readers and ``euroc_stream`` equal the JAX package's value for value and
item for item, frames included; ``run_sequence`` makes the same pipeline
calls. PNG types the reader does not take raise ``ValueError``. The slow
end-to-end run mirrors tests/test_dataset_e2e.py on the port (ATE < 0.25 m).
"""

import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch

from lfvio_tpu.runtime import datasets as jds
from lfvio_tpu_torch.runtime import datasets as tds

cv2 = pytest.importorskip("cv2")

FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH")


def png_bytes(width, height, depth=8, colour=0, interlace=0, raw=b""):
    """A PNG with the given header and image data."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, interlace)
    return (tds.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", FILTERS + ("ALL_FILTERS",))
def test_png_reader_matches_cv2(tmp_path, filt):
    """Random bytes and a smooth ramp (long runs for Sub / Up / Average /
    Paeth to predict) through cv2.imwrite with one row filter (or libpng's
    adaptive choice among all five), read back by both."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:61, 0:83]
    for k, img in enumerate((rng.integers(0, 256, (61, 83)).astype(np.uint8),
                             ((xx * 3 + yy * 5) % 256).astype(np.uint8))):
        path = str(tmp_path / f"{k}.png")
        flag = getattr(cv2, f"IMWRITE_PNG_{filt}" if filt == "ALL_FILTERS" else f"IMWRITE_PNG_FILTER_{filt}")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
        ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        got = tds.read_png_gray(path)
        assert got.dtype == np.uint8 and np.array_equal(got, ref) and np.array_equal(got, img)


@pytest.mark.parametrize("case, words", [
    (dict(colour=2), "colour type 2 (RGB)"),
    (dict(colour=3), "colour type 3 (palette)"),
    (dict(colour=4), "colour type 4 (greyscale+alpha)"),
    (dict(depth=16), "bit depth 16"),
    (dict(depth=1), "bit depth 1"),
    (dict(interlace=1), "interlace method 1"),
])
def test_png_reader_refuses_other_types(case, words):
    with pytest.raises(ValueError, match=re.escape(words)):
        tds.decode_png_gray(png_bytes(4, 3, raw=bytes(15), **case))


def test_png_reader_refuses_damaged_files():
    good = png_bytes(4, 3, raw=bytes(15))
    assert tds.decode_png_gray(good).shape == (3, 4)
    with pytest.raises(ValueError, match="signature"):
        tds.decode_png_gray(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="CRC"):
        tds.decode_png_gray(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError, match="holds 12 bytes"):
        tds.decode_png_gray(png_bytes(4, 3, raw=bytes(12)))


def write_euroc_dir(root, n_frames=6, n_imu=41, shape=(24, 32)):
    """A small EuRoC-layout directory: 200 Hz IMU, 20 Hz frames, GT."""
    rng = np.random.default_rng(1)
    mav0 = os.path.join(root, "mav0")
    for sub in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav0, sub))
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for k in range(n_imu):
            f.write(f"{1403636579758555392 + 5000000 * k}," + ",".join(
                repr(float(v)) for v in rng.standard_normal(6)) + "\n")
    with open(os.path.join(mav0, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k in range(n_frames):
            tns = 1403636579763555584 + 50000000 * k
            cv2.imwrite(os.path.join(mav0, "cam0", "data", f"{tns}.png"),
                        rng.integers(0, 256, shape).astype(np.uint8))
            f.write(f"{tns}, {tns}.png\n")
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x,v_y,v_z,bw_x,bw_y,bw_z,ba_x,ba_y,ba_z\n")
        for k in range(7):
            f.write(f"{1403636579758555392 + 10000000 * k}," + ",".join(
                repr(float(v)) for v in rng.standard_normal(16)) + "\n")
    return mav0


def test_csv_readers_and_stream_match_jax(tmp_path):
    mav0 = write_euroc_dir(str(tmp_path))
    for a, b in zip(jds.read_euroc_imu(f"{mav0}/imu0/data.csv"),
                    tds.read_euroc_imu(f"{mav0}/imu0/data.csv"), strict=True):
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert (jds.read_euroc_cam_index(f"{mav0}/cam0/data.csv")
            == tds.read_euroc_cam_index(f"{mav0}/cam0/data.csv"))
    gt = f"{mav0}/state_groundtruth_estimate0/data.csv"
    for a, b in zip(jds.read_euroc_groundtruth(gt), tds.read_euroc_groundtruth(gt), strict=True):
        assert np.array_equal(a, b)
    n_frames = 0
    for a, b in zip(jds.euroc_stream(mav0), tds.euroc_stream(mav0), strict=True):
        assert a[0] == b[0] and a[1] == b[1]
        if a[0] == "imu":
            assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
        else:
            ja, tb = a[2](), b[2]()
            assert tb.dtype == ja.dtype == np.float32 and np.array_equal(ja, tb)
            n_frames += 1
    assert n_frames == 6


def test_run_sequence_makes_the_same_calls(tmp_path):
    mav0 = write_euroc_dir(str(tmp_path))

    class Recorder:
        def __init__(self):
            self.calls, self.est = [], "est"

        def feed_imu(self, t, acc, gyr):
            self.calls.append(("imu", t, tuple(acc), tuple(gyr)))

        def feed_frame(self, t, img):
            self.calls.append(("frame", t, img.dtype.str, float(img.sum())))

    for max_frames in (None, 4):
        a, b = Recorder(), Recorder()
        assert jds.run_sequence(a, jds.euroc_stream(mav0), max_frames) == "est"
        assert tds.run_sequence(b, tds.euroc_stream(mav0), max_frames) == "est"
        assert a.calls == b.calls


@pytest.mark.slow
def test_euroc_directory_end_to_end(tmp_path):
    """tests/test_dataset_e2e.py on the port: a synthetic EuRoC-layout
    directory (512x384 PNGs, 15 Hz, 200 Hz IMU, 6 s) through euroc_stream,
    run_sequence and the port's VioPipeline on the CPU; ATE < 0.25 m."""
    from lfvio_tpu_torch.runtime import Estimator, EstimatorConfig, FrontEnd, VioPipeline
    from lfvio_tpu_torch.runtime.evaluation import ate_rmse
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=torch.float64),
                           dtype=torch.float64, device="cpu")
    mav0 = os.path.join(str(tmp_path), "mav0")
    for sub in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav0, sub))
    ts = np.arange(int(6.0 * 200) + 1) / 200.0
    acc, om = world.imu_batch(ts)
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for k in range(len(ts)):
            f.write(f"{int(ts[k] * 1e9)},{om[k][0]},{om[k][1]},{om[k][2]},"
                    f"{acc[k][0]},{acc[k][1]},{acc[k][2]}\n")
    with open(os.path.join(mav0, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k in range(int(6.0 * 15)):
            tns = int((k / 15.0 + 1e-4) * 1e9)
            img = world.render(tns * 1e-9).numpy()
            cv2.imwrite(os.path.join(mav0, "cam0", "data", f"{tns}.png"),
                        np.clip(img, 0, 255).astype(np.uint8))
            f.write(f"{tns},{tns}.png\n")
    gt_t = np.arange(0, 6.0, 0.02)
    gt_p, gt_q = world.pose_batch(gt_t)
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for k in range(len(gt_t)):
            f.write(f"{int(gt_t[k] * 1e9)}," + ",".join(map(str, [*gt_p[k], *gt_q[k]])) + "\n")

    fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                  n_slots=160, annulus=(world.width / 2, world.height / 2, SYN_MAX_R, SYN_MIN_R),
                  equalize=False, dtype=torch.float32, device="cpu")
    est = Estimator(EstimatorConfig(n_feature_slots=256, solver_dtype=torch.float64, device="cpu"))
    pipe = VioPipeline(fe, est)
    tds.run_sequence(pipe, tds.euroc_stream(mav0))
    pipe.flush()
    assert est.solver_flag == est.NON_LINEAR and len(est.times) > 25
    gt_t, gt_p, _ = tds.read_euroc_groundtruth(
        os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"))
    ate, n = ate_rmse(np.asarray(est.times), np.asarray(est.traj_p), gt_t, gt_p)
    assert n > 25 and ate < 0.25, ate
