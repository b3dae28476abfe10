"""The JAX FrontEnd's other configurations on the port, against the JAX
package on the CPU: the LK of the Pallas kernel's geometry
(``klt.pyramidal_lk_pallas`` against ``klt_pallas.pyramidal_lk_pallas`` in
interpret mode), and ``FrontEnd``'s ``n_levels``, ``border``,
``refine_win``, ``use_pallas`` and ``id_counter`` over a rendered sequence.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_klt_pallas import _shifted, _textured

from lfvio_tpu.frontend import gaussian_pyramid as j_pyramid
from lfvio_tpu.frontend.klt_pallas import pyramidal_lk_pallas as j_pyramidal_lk_pallas
from lfvio_tpu.runtime import tracker as jtr
from lfvio_tpu.runtime.synthetic import (
    SYN_MAX_R,
    SYN_MIN_R,
    SyntheticWorld as JWorld,
    make_synthetic_pal_camera as j_pal_camera,
)

from lfvio_tpu_torch.frontend import gaussian_pyramid, klt
from lfvio_tpu_torch.runtime import synthetic as tsyn
from lfvio_tpu_torch.runtime.tracker import FrontEnd, IdCounter

F64 = torch.float64
# Both LKs run in float32 (the Pallas form whatever the pyramid's dtype);
# their sums differ in order only: 3.1e-5 px apart at most here.
TRACK_PX = 1e-3

# ----------------------------------------------------------- the plain LK
H, W, N = 240, 320, 16


def _case(name):
    """(shift, pts, valid, n_levels) of a case on test_klt_pallas.py's
    textured scene (one N and one image size, so the interpret-mode JAX
    kernel compiles once per level shape)."""
    rng = np.random.default_rng(1)
    valid = np.ones(N, bool)
    valid[-2:] = False
    inside = np.stack([rng.uniform(60, W - 60, N), rng.uniform(60, H - 60, N)], -1)
    if name == "shift":  # test_klt_pallas.py's
        return (3.3, -2.6), inside, valid, 2
    if name == "far_at_level_0":
        # klt.py's search offsets stay in [0, 12], 6 px either way; the
        # Pallas geometry's reach [0, 22] x [0, 214].
        return (9.3, 3.4), inside, valid, 0
    if name == "wander_at_level_0":
        # Far enough that windows leave the band of columns the kernel
        # stages around a pass's first offset (SEARCH_MARGIN px and more
        # either way), so the kernel restages it.
        return (14.6, 2.2), inside, valid, 0
    # Features by the right and bottom edges, the outermost just outside
    # the image (where a template tap lies outside its patch).
    edge = lambda size: np.linspace(size - 28, size + 20, N // 2)
    xs = np.concatenate([edge(W), rng.uniform(60, W - 60, N // 2)])
    ys = np.concatenate([rng.uniform(60, H - 60, N // 2), edge(H)])
    valid = np.ones(N, bool)
    valid[3] = False
    return (-2.1, 1.7), np.stack([xs, ys], -1), valid, 2


def _edge_geometry(pts):
    """At level 0 of the edge case with no guess, written out from
    klt_pallas.py:111-138: whether a feature's search origin clamps to
    Wt-256 or Ht-64, and whether
    a tap of its 43x43 template sample lies outside the 56x256 patch."""
    Ht, Wt = klt.pallas_tile_shape(H, W)
    px, py = pts[:, 0] + klt.PAD, pts[:, 1] + klt.PAD
    tlx = np.clip(np.floor(px).astype(int) - 22, 0, Wt - 256) // 128 * 128
    tly = np.clip(np.floor(py).astype(int) - 22, 0, Ht - 56) // 8 * 8
    clamps = (np.floor(px).astype(int) - 26 > Wt - 256) | (np.floor(py).astype(int) - 26 > Ht - 64)
    last_col = np.floor(px - tlx - 21).astype(int) + 43
    last_row = np.floor(py - tly - 21).astype(int) + 43
    return clamps, (last_col >= 256) | (last_row >= 56)


@pytest.mark.parametrize("name", ["shift", "far_at_level_0", "wander_at_level_0", "edges"])
def test_plain_pallas_lk_matches_jax(name):
    """The plain pyramidal_lk_pallas against the JAX function (interpret
    mode): ok equal, every track within TRACK_PX. In the wander case valid
    features move past the kernel's band in their one pass; on this 8-px
    block texture LK past ~9 px finds wrong minima, so recovery is not
    asserted there."""
    shift, pts, valid, n_levels = _case(name)
    img0 = _textured(H, W)
    img1 = _shifted(img0, -shift[0], -shift[1])
    pts = pts.astype(np.float32)
    j_pts, j_ok = j_pyramidal_lk_pallas(
        list(j_pyramid(jnp.asarray(img0), n_levels)), list(j_pyramid(jnp.asarray(img1), n_levels)),
        jnp.asarray(pts), jnp.asarray(valid), n_levels, interpret=True)
    pyr0 = gaussian_pyramid(torch.as_tensor(img0), n_levels)
    pyr1 = gaussian_pyramid(torch.as_tensor(img1), n_levels)
    args = (pyr0, pyr1, torch.as_tensor(pts), torch.as_tensor(valid), n_levels)
    t_pts, t_ok = klt.pyramidal_lk_pallas(*args)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_allclose(t_pts.numpy(), np.asarray(j_pts), atol=TRACK_PX, rtol=0)
    ok = t_ok.numpy()
    err = np.linalg.norm(t_pts.numpy() - (pts + shift), axis=-1)
    if name == "edges":
        clamps, zero_tap = _edge_geometry(pts[valid])
        assert clamps.any() and zero_tap.any()
        assert 4 <= ok.sum() <= N - 4  # features leave the image: a mix
    elif name == "wander_at_level_0":
        moved = np.linalg.norm(t_pts.numpy() - pts, axis=-1)[valid]
        assert moved.max() > klt.SEARCH_MARGIN + 2
    else:
        assert ok.sum() >= N - 4 and np.median(err[ok]) < 0.35
    if name == "far_at_level_0":
        # klt.py's geometry loses this shift: the test would catch it.
        k_pts, k_ok = klt.pyramidal_lk(*args)
        k_err = np.linalg.norm(k_pts.numpy() - (pts + shift), axis=-1)
        assert (k_ok.numpy() & (k_err < 0.5)).sum() <= 4


# ------------------------------------------------------- the FrontEnd
CONFIGS = {
    "refine0_levels2_border3": dict(refine_win=0, n_levels=2, border=3),
    "use_pallas": dict(use_pallas=True),
}
# (bearing, velocity) bounds. klt.py's LK: as test_torch_pipeline.py's
# (its float32 sampler on the JAX side). The Pallas form's: its tracks are
# float32 on both sides, up to TRACK_PX apart, and this camera's bearings
# turn by about 1/60 rad a pixel (a 190 px annulus over 180 degrees): 2e-5
# for a bearing, and 15 times that (a frame's 1/15 s) for a velocity.
BEARING_TOL = {"refine0_levels2_border3": (1e-6, 1e-5), "use_pallas": (2e-5, 3e-4)}
BASE = dict(max_cnt=120, min_dist=15, n_slots=160, equalize=False)


@pytest.fixture(scope="module")
def worlds():
    return (JWorld(camera=j_pal_camera(dtype=jnp.float64)),
            tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                                device="cpu"))


@pytest.fixture(scope="module")
def jax_frontends(worlds):
    """One JAX FrontEnd per configuration, shared by the tests (each
    instance compiles its own programs)."""
    jw = worlds[0]
    annulus = (jw.width / 2, jw.height / 2, SYN_MAX_R, SYN_MIN_R)
    return {name: jtr.FrontEnd(jw.camera, (jw.height, jw.width), dtype=jnp.float64,
                               annulus=annulus, **BASE, **kw)
            for name, kw in CONFIGS.items()}


def _port_frontend(worlds, id_counter=None, **kw):
    jw, tw = worlds
    return FrontEnd(tw.camera, (jw.height, jw.width), dtype=F64, device="cpu",
                    annulus=(jw.width / 2, jw.height / 2, SYN_MAX_R, SYN_MIN_R),
                    id_counter=id_counter, **BASE, **kw)


def _reset_jax(jfe):
    """jfe.reset() after use: the JAX FrontEnd's finalize leaves self.pos a
    read-only array fetched from the device, which reset writes into."""
    jfe.pos = np.array(jfe.pos)
    jfe.reset()


def _hand_over_draws(jfe, tfe):
    """The RANSAC uniforms the JAX FrontEnd's next step draws
    (tracker.py:226), handed to the port's."""
    _, sub = jax.random.split(jfe.key)
    u = np.asarray(jax.random.uniform(sub, (100, tfe.N)))
    tfe.ransac_draws = lambda: torch.as_tensor(u)


def _frame_pair(jfe, tfe, img, t):
    if tfe.prev_pyr is not None:
        _hand_over_draws(jfe, tfe)
    return jfe.process_arrays(img, t), tfe.process_arrays(img, t)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_frontend_config_matches_jax(worlds, jax_frontends, name):
    """Seven frames through both FrontEnds (test_torch_pipeline.py's
    sequence, f64 FrontEnds). Ids and publish masks exactly equal; bearings
    and velocities within BEARING_TOL, rows within TRACK_PX. With
    use_pallas the JAX
    FrontEnd must still be on its Pallas path afterwards (it falls back to
    XLA on a kernel failure)."""
    jw = worlds[0]
    jfe = jax_frontends[name]
    _reset_jax(jfe)
    tfe = _port_frontend(worlds, **CONFIGS[name])
    n_pub = []
    for k in range(7):
        jo, to = _frame_pair(jfe, tfe, jw.render(k / 15.0), k / 15.0)
        if k == 0:
            assert jo is None and to is None
            continue
        np.testing.assert_array_equal(to[0], jo[0])
        np.testing.assert_array_equal(to[4], jo[4])
        np.testing.assert_allclose(to[1], jo[1], atol=BEARING_TOL[name][0])
        np.testing.assert_allclose(to[2], jo[2], atol=BEARING_TOL[name][1])
        np.testing.assert_allclose(to[3], jo[3], atol=TRACK_PX)
        n_pub.append(int(to[4].sum()))
    assert min(n_pub) > 60
    assert jfe.use_pallas == CONFIGS[name].get("use_pallas", False)
    assert (tfe.n_levels, tfe.border, tfe.refine_win, tfe.use_pallas) == (
        jfe.n_levels, jfe.border, jfe.refine_win, jfe.use_pallas)


def test_shared_id_counter_matches_jax(worlds, jax_frontends):
    """Two port FrontEnds built with one id_counter draw their ids from one
    sequence, as two JAX FrontEnds sharing an IdCounter do: the same ids
    frame by frame, none shared between the two."""
    jw = worlds[0]
    jfes = list(jax_frontends.values())
    j_ids = jtr.IdCounter()
    for jfe in jfes:
        _reset_jax(jfe)
        jfe._ids_src = j_ids
    t_ids = IdCounter()
    tfes = [_port_frontend(worlds, id_counter=t_ids, **kw) for kw in CONFIGS.values()]
    for k in range(4):
        img = jw.render(k / 15.0)
        outs = [_frame_pair(jfe, tfe, img, k / 15.0) for jfe, tfe in zip(jfes, tfes)]
        for jfe, tfe in zip(jfes, tfes):
            np.testing.assert_array_equal(tfe.ids, jfe.ids)
        live = [tfe.ids[tfe.ids >= 0] for tfe in tfes]
        assert len(live[0]) > 60 and not set(live[0]) & set(live[1])
        if k:
            for jo, to in outs:
                np.testing.assert_array_equal(to[4], jo[4])
    assert t_ids.next == j_ids.next > 2 * 60
