"""Parity of the port's geometry, camera and front-end modules with the JAX
package, on the same numpy inputs, in float64 on the CPU.

Bounds: 1e-12 for closed-form geometry (the same formulas, f64 rounding);
exact equality for masks, ids and integer selections; the LK bound is
stated at its test. The CUDA kernel's tests are in test_torch_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lfvio_tpu import geom as jgeom
from lfvio_tpu.cam import models as jcam
from lfvio_tpu.runtime.synthetic import (
    SYN_MAX_R,
    SYN_MIN_R,
    SyntheticWorld as JWorld,
    make_synthetic_pal_camera as j_pal_camera,
)

import lfvio_tpu_torch.geom as tgeom
from lfvio_tpu_torch.cam import models as tcam
from lfvio_tpu_torch.frontend import klt_cuda
from lfvio_tpu_torch.runtime import synthetic as tsyn

jmod = {m: importlib.import_module(f"lfvio_tpu.frontend.{m}")
        for m in ("clahe", "pyramid", "detect", "ransac", "klt")}
tmod = {m: importlib.import_module(f"lfvio_tpu_torch.frontend.{m}")
        for m in ("clahe", "pyramid", "detect", "ransac", "klt")}

F64 = torch.float64


def t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def unit_quats(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def frames():
    """Two rendered 512x384 frames of the synthetic PAL world, 1/15 s
    apart (rendered by the JAX package)."""
    world = JWorld(camera=j_pal_camera(dtype=jnp.float64))
    return world, world.render(0.0), world.render(1.0 / 15.0)


# ------------------------------------------------------------------ geom
_rng = np.random.default_rng(0)
_V = _rng.standard_normal((7, 3))
_Q = unit_quats(7, 1)
_P = unit_quats(7, 2)
_TH = np.concatenate([_V * 0.7, np.zeros((1, 3)), 1e-9 * np.ones((1, 3))])
_B = _V / np.linalg.norm(_V, axis=-1, keepdims=True)
_B2 = np.concatenate([_B, [[0.0, 0.0, 1.0]]])
_R = np.asarray(jgeom.quat_to_mat(jnp.asarray(_Q)))
GEOM_CASES = {
    "skew": (_V,), "quat_normalize": (_Q * 3.0,), "quat_mul": (_Q, _P),
    "quat_conj": (_Q,), "quat_rotate": (_Q, _V), "quat_from_small_angle": (_V,),
    "quat_to_mat": (_Q,), "mat_to_quat": (_R,), "quat_left": (_Q,),
    "quat_right": (_Q,), "quat_positify": (-_Q,), "quat_box_minus": (_Q, _P),
    "so3_exp": (_TH,), "so3_log": (_Q,), "R_to_ypr_deg": (_R,),
    "ypr_deg_to_R": (_V * 40.0,), "g2R": (_V + [0, 0, 9.81],),
    "tangent_basis": (_B2,), "quat_from_two_vectors": (_B, _B[::-1]),
}


@pytest.mark.parametrize("name", sorted(GEOM_CASES))
def test_geom_rotations_parity(name):
    args = GEOM_CASES[name]
    ja = np.asarray(getattr(jgeom, name)(*[jnp.asarray(a) for a in args]))
    ta = getattr(tgeom, name)(*[t(a) for a in args]).numpy()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-12)


def test_geom_host_copy_matches_jax_host():
    from lfvio_tpu.geom import host as jh
    from lfvio_tpu_torch.geom import host as th

    for fn, args in (("quat_mul", (_Q[0], _P[0])), ("quat_to_mat", (_Q[0],)),
                     ("mat_to_quat", (_R[0],)), ("so3_exp", (_V[0],)),
                     ("so3_log", (_Q[0],)), ("R_to_ypr_deg", (_R[0],)),
                     ("ypr_deg_to_R", (_V[0] * 30,)), ("g2R", (_V[0] + [0, 0, 9.81],))):
        np.testing.assert_array_equal(getattr(th, fn)(*args), getattr(jh, fn)(*args))


# ---------------------------------------------------------------- camera
def test_scaramuzza_parity():
    """Lift (incl. the z<0 half of the annulus), unit lift and projection;
    camera_from_dict on the reference YAML layout."""
    jc = j_pal_camera(dtype=jnp.float64)
    tc = tsyn.make_synthetic_pal_camera(dtype=F64)
    rng = np.random.default_rng(4)
    r = rng.uniform(SYN_MIN_R, SYN_MAX_R, 300)
    a = rng.uniform(0, 2 * np.pi, 300)
    px = np.stack([256 + r * np.cos(a), 192 + r * np.sin(a)], -1)
    jl = np.asarray(jc.lift_projective(jnp.asarray(px)))
    assert (jl[:, 2] < 0).any() and (jl[:, 2] > 0).any()
    np.testing.assert_allclose(tc.lift_projective(t(px)).numpy(), jl, atol=1e-9)
    js = np.asarray(jc.lift_sphere(jnp.asarray(px)))
    np.testing.assert_allclose(tc.lift_sphere(t(px)).numpy(), js, atol=1e-12)
    P = js * rng.uniform(0.5, 5.0, (300, 1))
    np.testing.assert_allclose(
        tc.space_to_plane(t(P)).numpy(), np.asarray(jc.space_to_plane(jnp.asarray(P))), atol=1e-9
    )
    cfg = {
        "model_type": "SCARAMUZZA",
        "poly_parameters": {f"p{i}": float(jc.poly[i]) for i in range(5)},
        "inv_poly_parameters": {f"p{i}": float(jc.inv_poly[i]) for i in range(20)},
        "affine_parameters": {"ac": 1.0, "ad": 0.01, "ae": -0.02, "cx": 250.0, "cy": 190.0},
    }
    jd = jcam.camera_from_dict(cfg, dtype=jnp.float64)
    td = tcam.camera_from_dict(cfg, dtype=F64)
    np.testing.assert_allclose(td.lift_sphere(t(px)).numpy(),
                               np.asarray(jd.lift_sphere(jnp.asarray(px))), atol=1e-12)
    with pytest.raises(ValueError):
        tcam.camera_from_dict({"model_type": "PINHOLE"})


# ------------------------------------------------------------- image ops
def test_pyramid_parity(frames):
    _, img, _ = frames
    ja = jmod["pyramid"].gaussian_pyramid(jnp.asarray(img), 3)
    ta = tmod["pyramid"].gaussian_pyramid(t(img), 3)
    for a, b in zip(ja, ta):
        assert a.shape == b.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-10)


def test_clahe_parity(frames):
    """Against both JAX forms, run op by op: the main path's one-hot MXU
    form and the gather form (they are the same function of the image)."""
    _, img, _ = frames
    tb = tmod["clahe"].clahe(t(img)).numpy()
    np.testing.assert_allclose(tb, np.asarray(jmod["clahe"].clahe(jnp.asarray(img))), atol=1e-9)
    np.testing.assert_allclose(
        tb, np.asarray(jmod["clahe"]._clahe_gather(jnp.asarray(img), 3.0, 8, 256)), atol=1e-9)


def test_detect_parity(frames):
    """Shi-Tomasi response, annulus mask, exclusion zones and the selected
    corners (identical points and flags)."""
    _, img, _ = frames
    jd, td = jmod["detect"], tmod["detect"]
    jr = np.asarray(jd.shi_tomasi_response(jnp.asarray(img)))
    tr = td.shi_tomasi_response(t(img))
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-9)
    jm = np.asarray(jd.annulus_mask((384, 512), 256.0, 192.0, SYN_MAX_R, SYN_MIN_R, jnp.float64))
    tm = td.annulus_mask((384, 512), 256.0, 192.0, SYN_MAX_R, SYN_MIN_R, F64)
    np.testing.assert_array_equal(tm.numpy(), jm)
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 384, (40, 2))
    ok = rng.random(40) < 0.7
    np.testing.assert_array_equal(
        td.occupancy_dilated((384, 512), t(pts), torch.as_tensor(ok), 15).numpy(),
        np.asarray(jd.occupancy_dilated((384, 512), jnp.asarray(pts), jnp.asarray(ok), 15)))
    jp, jok = jd.select_features(jnp.asarray(jr), jnp.asarray(jm), jnp.asarray(pts),
                                 jnp.asarray(ok), 120, 15)
    tp, tok = td.select_features(t(jr), tm, t(pts), torch.as_tensor(ok), 120, 15)
    assert int(tok.sum()) > 50
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_ransac_parity():
    """Same draws in, same inliers out; E equal up to sign."""
    rng = np.random.default_rng(6)
    N = 90
    b1 = rng.standard_normal((N, 3))
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    R = np.asarray(jgeom.quat_to_mat(jnp.asarray(unit_quats(1, 3)[0] * [1, .1, .1, .1])))
    X = b1 * rng.uniform(2, 6, (N, 1))
    b2 = (X - [0.3, 0.1, -0.05]) @ R
    b2 += 0.0005 * rng.standard_normal(b2.shape)
    b2[:12] = rng.standard_normal((12, 3))  # outliers
    b2 /= np.linalg.norm(b2, axis=-1, keepdims=True)
    valid = np.ones(N, bool)
    valid[-5:] = False
    key = jax.random.PRNGKey(11)
    jE, jin = jmod["ransac"].spherical_ransac_e(key, jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(valid))
    u = np.asarray(jax.random.uniform(key, (100, N)))
    tE, tin = tmod["ransac"].spherical_ransac_e(t(u), t(b1), t(b2), torch.as_tensor(valid))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    assert 60 < int(tin.sum()) < N - 10
    jE = np.asarray(jE)
    s = np.sign(np.sum(jE * tE.numpy()))
    np.testing.assert_allclose(s * tE.numpy(), jE, atol=1e-9)


# ------------------------------------------------------------------- LK
@pytest.fixture(scope="module")
def lk_case(frames):
    """Pyramids of two consecutive frames and 48 corners (3 invalid)."""
    _, img0, img1 = frames
    pyr0 = [np.asarray(x) for x in jmod["pyramid"].gaussian_pyramid(jnp.asarray(img0), 3)]
    pyr1 = [np.asarray(x) for x in jmod["pyramid"].gaussian_pyramid(jnp.asarray(img1), 3)]
    resp = jmod["detect"].shi_tomasi_response(jnp.asarray(img0))
    mask = jmod["detect"].annulus_mask((384, 512), 256.0, 192.0, SYN_MAX_R, SYN_MIN_R, jnp.float64)
    pts, ok = jmod["detect"].select_features(resp, mask, jnp.zeros((1, 2)), jnp.zeros((1,), bool), 48, 15)
    valid = np.asarray(ok).copy()
    valid[:3] = False
    return pyr0, pyr1, np.asarray(pts, np.float64), valid


@pytest.mark.parametrize("refine_win", [0, 15])
def test_plain_lk_parity(lk_case, refine_win):
    """The plain LK against klt.pyramidal_lk: ok identical, positions
    within 1e-4 px — the JAX sampler accumulates in float32
    (preferred_element_type, klt.py:79-86) while the port's f64 run does not."""
    pyr0, pyr1, pts, valid = lk_case
    jp, jok = jmod["klt"].pyramidal_lk([jnp.asarray(x) for x in pyr0], [jnp.asarray(x) for x in pyr1],
                                       jnp.asarray(pts), jnp.asarray(valid), 3, refine_win=refine_win)
    tp, tok = tmod["klt"].pyramidal_lk([t(x) for x in pyr0], [t(x) for x in pyr1],
                                       t(pts), torch.as_tensor(valid), 3, refine_win=refine_win)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() >= 35 and not jok[:3].any()
    np.testing.assert_allclose(tp.numpy()[jok], np.asarray(jp)[jok], atol=1e-4)


def test_lk_level_wrapper_takes_plain_version_on_cpu(lk_case):
    """On CPU tensors the kernel wrapper runs klt.track_level (and counts
    no launch); the level loop over it equals the plain one there."""
    pyr0, pyr1, pts, valid = lk_case
    before = klt_cuda.lk_level.launches
    a = tmod["klt"].lk_pyramid(klt_cuda.lk_level, [t(x) for x in pyr0], [t(x) for x in pyr1],
                               t(pts), torch.as_tensor(valid), 3, 15)
    b = tmod["klt"].pyramidal_lk([t(x) for x in pyr0], [t(x) for x in pyr1],
                                 t(pts), torch.as_tensor(valid), 3, refine_win=15)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert klt_cuda.lk_level.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_lk_pyramid_wrapper_takes_plain_version_on_cpu(lk_case, dtype):
    """On CPU tensors the fused kernel's wrapper, which the FrontEnd calls,
    is klt.pyramidal_lk exactly, in either dtype, and counts no launch."""
    pyr0, pyr1, pts, valid = lk_case
    c = lambda x: torch.as_tensor(np.array(x), dtype=dtype)
    args = ([c(x) for x in pyr0], [c(x) for x in pyr1], c(pts), torch.as_tensor(valid), 3)
    before = klt_cuda.lk_pyramid.launches
    a = klt_cuda.pyramidal_lk(*args, refine_win=15)
    b = tmod["klt"].pyramidal_lk(*args, refine_win=15)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].sum() >= 35
    assert klt_cuda.lk_pyramid.launches == before


def _bad_lk_arguments(pyr0, pyr1, pts, valid):
    """Arguments the fused kernel's wrapper refuses, by name."""
    return {
        "dtype differs between pyramids": ([x.double() for x in pyr0], pyr1, pts, valid, 3),
        "pts dtype": (pyr0, pyr1, pts.double(), valid, 3),
        "pts shape": (pyr0, pyr1, pts[:, :1], valid, 3),
        "valid dtype": (pyr0, pyr1, pts, valid.to(torch.uint8), 3),
        "valid length": (pyr0, pyr1, pts, valid[:-1], 3),
        "level shapes differ": (pyr0, pyr1[:3] + [pyr1[3][:, :-1].contiguous()], pts, valid, 3),
        "levels do not halve": (pyr0[:1] + [pyr0[1][:-1]] + pyr0[2:],
                                pyr1[:1] + [pyr1[1][:-1]] + pyr1[2:], pts, valid, 3),
        "non-contiguous level": ([pyr0[0].t().contiguous().t()] + pyr0[1:], pyr1, pts, valid, 3),
        "too few levels": (pyr0[:3], pyr1[:3], pts, valid, 3),
        "3-D level": ([pyr0[0][None]] + pyr0[1:], pyr1, pts, valid, 3),
    }


@pytest.mark.parametrize("case", [
    "dtype differs between pyramids", "pts dtype", "pts shape", "valid dtype", "valid length",
    "level shapes differ", "levels do not halve", "non-contiguous level", "too few levels",
    "3-D level"])
def test_lk_pyramid_wrapper_argument_checks(lk_case, case):
    """The wrapper's checks that need no card raise on CPU tensors too."""
    pyr0, pyr1, pts, valid = lk_case
    c = lambda x: torch.as_tensor(np.array(x), dtype=torch.float32)
    bad = _bad_lk_arguments([c(x) for x in pyr0], [c(x) for x in pyr1], c(pts),
                            torch.as_tensor(valid))[case]
    with pytest.raises(ValueError, match="lk_pyramid"):
        klt_cuda.pyramidal_lk(*bad, refine_win=15)


def test_camera_from_yaml_parity(tmp_path):
    """The reference rig YAML layout (OpenCV FileStorage subset) read by
    both packages gives the same camera."""
    jc = j_pal_camera(dtype=jnp.float64)
    lines = ["%YAML:1.0", "model_type: SCARAMUZZA", "camera_name: pal", "poly_parameters:"]
    lines += [f"   p{i}: {float(jc.poly[i])!r}" for i in range(5)]
    lines += ["inv_poly_parameters:"]
    lines += [f"   p{i}: {float(jc.inv_poly[i])!r}" for i in range(20)]
    lines += ["affine_parameters:", "   ac: 1.0", "   ad: 0.0", "   ae: 0.0",
              "   cx: 256.0", "   cy: 192.0"]
    path = tmp_path / "pal.yaml"
    path.write_text("\n".join(lines) + "\n")
    jy = jcam.camera_from_yaml(str(path), dtype=jnp.float64)
    ty = tcam.camera_from_yaml(str(path), dtype=F64)
    px = np.array([[300.0, 100.0], [100.0, 250.0], [256.0, 60.0]])
    np.testing.assert_allclose(ty.lift_sphere(t(px)).numpy(),
                               np.asarray(jy.lift_sphere(jnp.asarray(px))), atol=1e-12)
