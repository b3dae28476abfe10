"""The port's calibration tooling (``lfvio_tpu_torch.calib``) against the JAX
package's ``lfvio_tpu.calib``.

* Chessboard detection (float32 response on the CPU, as the JAX package
  computes it): ``found`` identical and the corners within 1e-6 px, on
  warped boards, a board with a missing corner row and an empty image.
* ``synth_chessboard_views``: the same boards, image points within 1e-9 px.
* Pinhole, Mei and Kannala-Brandt calibration on the JAX package's views:
  every intrinsic within 1e-8 relative (the solvers are the same numpy),
  and the recovery bounds of tests/test_calib.py.
* ``calibrate_scaramuzza`` (slow, as its JAX test): tests/test_calib.py's
  bounds on the port's cameras.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvio_tpu import calib as jcal
from lfvio_tpu import cam as jcam
from lfvio_tpu.calib import chessboard as jchess

from lfvio_tpu_torch import calib as tcal
from lfvio_tpu_torch import convert
from lfvio_tpu_torch.calib import chessboard as tchess


def board_image(Hm, rows=5, cols=7, sq=36, shape=(480, 640), seed=0, drop_row=False):
    """tests/test_calib.py's projectively warped chessboard with noise."""
    H, W = shape
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    Hi = np.linalg.inv(Hm)
    den = Hi[2, 0] * xx + Hi[2, 1] * yy + Hi[2, 2]
    bx = (Hi[0, 0] * xx + Hi[0, 1] * yy + Hi[0, 2]) / den
    by = (Hi[1, 0] * xx + Hi[1, 1] * yy + Hi[1, 2]) / den
    cx, cy = np.floor(bx / sq).astype(int), np.floor(by / sq).astype(int)
    n_rows = rows if drop_row else rows + 1
    inside = (bx >= 0) & (by >= 0) & (bx < (cols + 1) * sq) & (by < n_rows * sq)
    img = np.where(inside & (((cx + cy) % 2) == 0), 230.0, 25.0)
    img = np.where(inside, img, 128.0)
    return img + np.random.default_rng(seed).normal(0, 2.0, img.shape)


BOARDS = {
    "warped": board_image(np.array([[0.95, 0.08, 120.0], [-0.05, 1.02, 90.0],
                                    [1.2e-4, -8e-5, 1.0]])),
    "rotated": board_image(np.array([[0.8, -0.45, 260.0], [0.45, 0.8, 60.0],
                                     [5e-5, 1e-4, 1.0]]), seed=1),
    "missing row": board_image(np.array([[0.95, 0.08, 120.0], [-0.05, 1.02, 90.0],
                                         [1.2e-4, -8e-5, 1.0]]), drop_row=True),
    "empty": np.full((480, 640), 128.0) + np.random.default_rng(2).normal(0, 2.0, (480, 640)),
}


@pytest.mark.parametrize("name", list(BOARDS))
def test_chessboard_detection_matches_jax(name):
    img = BOARDS[name]
    jc, jfound = jchess.find_chessboard_corners(img, (5, 7))
    tc, tfound = tchess.find_chessboard_corners(img, (5, 7), device="cpu")
    assert jfound == tfound == (name in ("warped", "rotated"))
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    # The device part alone: candidates and scores.
    x = torch.as_tensor(img, dtype=torch.float32)
    tp, ts = tchess._detect_candidates(x / x.max() * 255.0, k=140)
    jx = jnp.asarray(img, jnp.float32)
    jp, js = jchess._detect_candidates(jx / jnp.max(jx) * 255.0, k=140)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    if tfound:  # the wrapper with the OpenCV (cols, rows) convention
        np.testing.assert_array_equal(tcal.find_chessboard_corners(img, (7, 5), device="cpu"), tc)


def port_camera(jax_cam):
    return convert.camera({f.name: np.asarray(getattr(jax_cam, f.name))
                           for f in dataclasses.fields(jax_cam)},
                          device="cpu", model=type(jax_cam).__name__)


PINHOLE = dict(fx=460.0, fy=455.0, cx=376.0, cy=240.0, k1=-0.28, k2=0.07, p1=2e-4, p2=1.5e-4)
MEI = dict(xi=0.9, k1=-0.15, k2=0.03, p1=3e-4, p2=-2e-4, gamma1=430.0, gamma2=425.0,
           u0=376.0, v0=240.0)
KB = dict(mu=405.0, mv=400.0, u0=376.0, v0=240.0, k2=-0.02, k3=0.004, k4=-0.001, k5=0.0002)


def kb_directions():
    return [[np.sin(p) * np.cos(a), np.sin(p) * np.sin(a), np.cos(p)]
            for p in np.radians([8.0, 20.0, 35.0]) for a in np.radians([0, 120, 240])]


CASES = {
    "pinhole": (jcam.PinholeCamera, PINHOLE, dict(n_views=8, depth=0.8, seed=3),
                jcal.calibrate_pinhole, tcal.calibrate_pinhole),
    "mei": (jcam.MeiCamera, MEI, dict(n_views=10, depth=0.8, seed=5),
            jcal.calibrate_mei, tcal.calibrate_mei),
    "kannala-brandt": (jcam.KannalaBrandtCamera, KB,
                       dict(n_views=9, depth=0.8, seed=6, directions=kb_directions()),
                       jcal.calibrate_kannala_brandt, tcal.calibrate_kannala_brandt),
}


@pytest.mark.parametrize("name", list(CASES))
def test_calibration_matches_jax(name):
    cls, params, view_kw, jcalib, tcalib = CASES[name]
    cam = cls(**{k: jnp.asarray(v) for k, v in params.items()})
    jobj, jimg, jext = jcal.synth_chessboard_views(cam, **view_kw)
    tobj, timg, text = tcal.synth_chessboard_views(port_camera(cam), **view_kw)
    assert len(timg) == len(jimg) == view_kw["n_views"]
    for a, b in zip(jimg, timg):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)
    for (Ra, ta), (Rb, tb), oa, ob in zip(jext, text, jobj, tobj):
        assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb) and np.array_equal(oa, ob)

    jp, _, jrms = jcalib(jobj, jimg, (752, 480))
    tp, _, trms = tcalib(jobj, jimg, (752, 480))
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(np.asarray(tp[k]), np.asarray(jp[k]), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(trms, jrms, rtol=1e-8, atol=1e-12)
    # tests/test_calib.py's recovery bounds, on the port's result.
    assert trms < 0.05
    for k in ("u0", "v0", "cx", "cy"):
        if k in params:
            assert abs(tp[k] - params[k]) < 1.0
    for k in ("fx", "fy"):
        if k in params:
            assert abs(tp[k] - params[k]) < 1.0
    for k in ("mu", "mv"):
        if k in params:
            assert abs(tp[k] - params[k]) < 2.0


@pytest.mark.slow
def test_calibrate_scaramuzza_recovers_model():
    """tests/test_calib.py::test_calibrate_scaramuzza_recovers_model on the
    port: boards over the PAL annulus, rms < 0.05 px, the calibrated model
    lifts annulus pixels within 0.25° of the true one."""
    from lfvio_tpu_torch.cam import ScaramuzzaCamera
    from lfvio_tpu_torch.runtime.synthetic import make_synthetic_pal_camera

    cam = make_synthetic_pal_camera(dtype=torch.float64)
    dirs = [[np.sin(p) * np.cos(a), np.sin(p) * np.sin(a), np.cos(p)]
            for p in np.radians([45.0, 70.0, 90.0, 105.0]) for a in np.radians([0, 90, 180, 270])]
    obj, img, _ = tcal.synth_chessboard_views(cam, 16, square=0.08, depth=0.8, seed=1,
                                              directions=dirs)
    params, _, rms = tcal.calibrate_scaramuzza(obj, img, (512, 384))
    assert rms < 0.05
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float64)
    cal = ScaramuzzaCamera(poly=t(params["poly"]), inv_poly=t(params["inv_poly"]), C=t(1.0),
                           D=t(0.0), E=t(0.0), cx=t(params["cx"]), cy=t(params["cy"]))
    ang = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    for r in (80.0, 120.0, 170.0):
        pix = t(np.stack([256.0 + r * np.cos(ang), 192.0 + r * np.sin(ang)], -1))
        cosang = (cam.lift_sphere(pix) * cal.lift_sphere(pix)).sum(-1).clamp(-1, 1)
        assert np.degrees(np.arccos(cosang.numpy())).max() < 0.25
