"""The port's panorama remap and AR overlay against the JAX package's.

* ``PanoramaRemapper`` in float64 on the CPU: maps and panorama within
  1e-9 of the JAX package's on the same camera and frame, plus the spot
  checks of tests/test_runtime_io.py::test_panorama_remap_roundtrip.
* ``ArRenderer``: projections within 1e-3 px (the port projects in float32,
  as the JAX package casts its points), the same drawable samples, and at
  least 99.9% of the rendered pixels equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfvio_tpu.runtime import ar_demo as jar
from lfvio_tpu.runtime import panorama as jpano
from lfvio_tpu.runtime.synthetic import make_synthetic_pal_camera as jax_pal_camera

from lfvio_tpu_torch import convert
from lfvio_tpu_torch.runtime import ar_demo as tar
from lfvio_tpu_torch.runtime import panorama as tpano
from lfvio_tpu_torch.runtime.synthetic import SyntheticWorld


@pytest.fixture(scope="module")
def cams():
    jcam = jax_pal_camera(dtype=jnp.float64)
    tcam = convert.camera({f.name: np.asarray(getattr(jcam, f.name))
                           for f in dataclasses.fields(jcam)}, device="cpu")
    return jcam, tcam


def test_panorama_matches_jax(cams):
    jcam, tcam = cams
    world = SyntheticWorld(camera=tcam, dtype=torch.float64, device="cpu")
    img = world.render(0.0).numpy()
    kw = dict(pano_width=256, pano_height=64, lat_min_deg=-35.0, lat_max_deg=35.0)
    j = jpano.PanoramaRemapper(jcam, img.shape, dtype=jnp.float64, **kw)
    t = tpano.PanoramaRemapper(tcam, img.shape, dtype=torch.float64, device="cpu", **kw)
    np.testing.assert_allclose(t.map_x.numpy(), j.map_x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.map_y.numpy(), j.map_y, rtol=0, atol=1e-9)
    pano = t.remap(img).numpy()
    np.testing.assert_allclose(pano, np.asarray(j.remap(img)), rtol=0, atol=1e-9)
    # tests/test_runtime_io.py's checks on the port's panorama.
    assert pano.shape == (64, 256)
    assert (pano > 1.0).mean() > 0.7
    assert pano.max() <= 255.0 and pano.min() >= 0.0
    ph, pw = pano.shape
    lon = -np.pi + 2 * np.pi * (pw // 4) / pw
    pix = tcam.space_to_plane(torch.tensor([np.cos(lon), np.sin(lon), 0.0])).numpy()
    assert abs(pano[ph // 2, pw // 4] - img[int(round(pix[1])), int(round(pix[0]))]) < 25.0


def test_panorama_of_a_float32_frame_on_its_default_size(cams):
    jcam, tcam = cams
    img = (np.arange(384 * 512, dtype=np.float32).reshape(384, 512) % 251).astype(np.float32)
    j = np.asarray(jpano.PanoramaRemapper(jcam, img.shape).remap(img))
    t = tpano.PanoramaRemapper(tcam, img.shape, device="cpu").remap(torch.as_tensor(img))
    assert t.shape == (256, 1024) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-3)


def test_ar_renderer_matches_jax(cams):
    jcam, tcam = cams
    renderers = []
    for mod, cam in ((jar, jcam), (tar, tcam)):
        ar = mod.ArRenderer(cam, 512, 384, samples_per_edge=16)
        ar.add_cube(center=[1.5, 0.2, 0.0], size=0.5)
        ar.add_cube(center=[-0.8, -1.6, 0.4], size=0.7, color=(255, 0, 255))
        ar.add_axes([0.3, 1.2, -0.2], length=0.8)
        renderers.append(ar)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    t = np.array([0.1, -0.2, 0.05])
    pj, pt = (r.project(R, t) for r in renderers)
    assert len(pj) == len(pt) == 5
    for (xj, okj, cj), (xt, okt, ct) in zip(pj, pt):
        assert cj == ct and np.array_equal(okj, okt) and okt.any()
        assert np.abs(xj - xt)[okt].max() < 1e-3
    img = np.full((384, 512), 40, np.uint8)
    rj, rt = (r.render(img, R, t, thickness=2) for r in renderers)
    assert rt.shape == (384, 512, 3) and (rt != 40).any()
    assert (rj == rt).all(axis=-1).mean() >= 0.999


def test_entry_points_default_to_the_card(cams):
    """The panorama, chessboard and window-problem entry points run on the CUDA card unless
    asked for the CPU, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for machines without one")
    from lfvio_tpu_torch.calib import chessboard
    from lfvio_tpu_torch.runtime.profiling import make_window_problem

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpano.PanoramaRemapper(cams[1], (384, 512))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chessboard.find_chessboard_corners(np.zeros((48, 64)), (3, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_window_problem(8)
