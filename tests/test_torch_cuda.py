"""The LK kernel (lfvio_tpu_torch/csrc/lk_pyramid.cu) on a CUDA card: the fused
launch per frame, and one level step as a one-pass launch of the same kernel.
The eigensolver kernel (lfvio_tpu_torch/csrc/sym_eig.cu) against
torch.linalg.eigh, and the estimator's programs as CUDA graphs against the
same functions run eagerly.

Every test here needs the card: the kernel has no CPU mode, so they skip
without one. This file imports neither JAX nor the JAX package, so it also
runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from lfvio_tpu_torch.frontend import gaussian_pyramid, klt, klt_cuda

pytestmark = pytest.mark.cuda

# Besides the loose bounds (ok on >= 99%, 0.05 px), a tight one: the
# largest kernel-vs-plain error seen on an H100 is 1.2e-4 px, so 2e-3 px
# still passes float32 sums in another order but catches a kernel that
# mishandles a few taps, such as clamping an out-of-patch tap instead of
# reading 0.
TIGHT_PX = 2e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _shift_case(dev, H=480, W=640, N=96, dx=2.7, dy=-1.9, seed=0, n_border=0, waves=False):
    """A smoothed blocky texture, its bilinear shift by (dx, dy), the
    pyramids of both and N points away from the border (4 invalid).
    ``n_border`` extra points lie within 30 px of the borders and corners;
    ``waves`` puts the texture on long waves that LK follows at coarse levels."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.random((H // 8, W // 8)), np.ones((8, 8)))
    for ax in (0, 1):  # 5-tap box blur
        img = sum(np.roll(img, s, axis=ax) for s in range(-2, 3)) / 5.0
    if waves:
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
        wave = sum(np.sin(2 * np.pi * (xx * np.cos(th) + yy * np.sin(th)) / lam + ph)
                   for lam, th, ph in zip(rng.uniform(160, 400, 12), rng.uniform(0, np.pi, 12),
                                          rng.uniform(0, 2 * np.pi, 12)))
        img = 0.15 * img + 0.85 * (wave - wave.min()) / (wave.max() - wave.min())
    img0 = torch.as_tensor(img * 255.0, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    grid = torch.stack([(xx - dx) / (W - 1) * 2 - 1, (yy - dy) / (H - 1) * 2 - 1], -1)
    img1 = torch.nn.functional.grid_sample(
        img0[None, None], grid[None].float(), mode="bilinear", align_corners=True,
        padding_mode="border")[0, 0]
    pts = np.stack([rng.uniform(50, W - 50, N), rng.uniform(50, H - 50, N)], -1)
    if n_border:
        near = lambda size: np.where(rng.random(n_border) < 0.5, rng.uniform(0, 30, n_border),
                                     size - 1 - rng.uniform(0, 30, n_border))
        side = np.arange(n_border) % 3  # 0: corner, 1: top/bottom, 2: left/right
        bx = np.where(side == 1, rng.uniform(0, W - 1, n_border), near(W))
        by = np.where(side == 2, rng.uniform(0, H - 1, n_border), near(H))
        pts = np.concatenate([pts, np.stack([bx, by], -1)])
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    valid[:4] = False
    return gaussian_pyramid(img0, 3), gaussian_pyramid(img1, 3), pts, valid, (dx, dy)


@pytest.mark.parametrize("win,iters", [(klt.WIN, klt.N_ITERS), (15, klt.REFINE_ITERS)])
def test_level_step_matches_plain(dev, win, iters):
    """One level step at both windows: ok on >= 99% of features alike and
    positions within 0.05 px (float32 sums in another order); tight: ok
    identical and positions within TIGHT_PX."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev)
    g0 = torch.zeros_like(pts)
    before = klt_cuda.lk_level.launches
    kg, kok = klt_cuda.lk_level(pyr0[0], pyr1[0], pts, g0, valid, win, iters)
    torch.cuda.synchronize()
    assert klt_cuda.lk_level.launches == before + 1
    pg, pok = klt.track_level(pyr0[0], pyr1[0], pts, g0, valid, win, iters)
    assert (kok == pok).float().mean().item() >= 0.99
    assert not kok[:4].any()
    both = kok & pok
    err = (kg[both] - pg[both]).abs().max().item()
    assert err < 0.05
    assert torch.equal(kok, pok)
    assert err < TIGHT_PX


@pytest.mark.parametrize("size", [(480, 640), (384, 512)])
def test_fused_pyramid_matches_plain_and_truth(dev, size):
    """The fused launch (all levels and the refine pass): one launch,
    agreement with the plain version under the loose and the tight bound,
    the known shift recovered (median error < 0.35 px), and the iteration
    counts it reports within their limits."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev, *size)
    before = klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches
    kp, kok, iters = klt_cuda.lk_pyramid(pyr0, pyr1, pts, valid, 3, refine_win=15,
                                         return_iters=True)
    torch.cuda.synchronize()
    assert (klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches) == (before[0] + 1, before[1])
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert (kok == pok).float().mean().item() >= 0.99
    both = kok & pok
    assert both.sum().item() >= len(pts) - 10
    err = (kp[both] - pp[both]).abs().max().item()
    assert err < 0.05
    assert err < TIGHT_PX
    truth = pts + torch.tensor([dx, dy], device=dev)
    assert torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item() < 0.35
    assert iters.shape == (len(pts), 5) and (iters[:4] == -1).all()
    limit = torch.tensor([klt.N_ITERS] * 4 + [klt.REFINE_ITERS], device=dev)
    assert (iters[kok] >= 0).all() and (iters <= limit).all() and (iters[kok].sum(1) > 0).all()


@pytest.mark.parametrize("size", [(960, 1280), (384, 512)])
def test_fused_border_and_corner_points(dev, size):
    """Points within 30 px of the borders and corners, where the edge
    replication (an index clamp in the kernel) and the patch clamps work:
    ok identical to the plain version's, positions within TIGHT_PX."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, *size, N=32, n_border=96, dx=3.3, dy=-2.6)
    kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert torch.equal(kok, pok)
    assert 8 <= kok[32:].sum().item() < 96  # some border points survive, some leave
    assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX


def test_fused_lost_tracks(dev):
    """A shift of 5.6 px at level 3 leaves the search patch for a part of
    the features: ok identical to the plain version's, a real mix of kept
    and lost, and a lost feature's guess still doubles down the levels."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, 960, 1280, N=192, dx=44.8, dy=-41.6, waves=True)
    kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert torch.equal(kok, pok)
    assert 16 <= kok.sum().item() <= len(pts) - 4 - 16
    assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX
    lost = valid & ~kok
    assert torch.isfinite(kp).all() and (kp[lost] - pp[lost]).abs().max().item() < 0.5


def test_fused_repeat_is_bit_identical(dev):
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, n_border=32)
    a = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    for _ in range(3):
        b = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_fused_without_refine_and_with_fewer_levels(dev):
    """refine_win 0 and a one-level pyramid go through the same kernel."""
    pyr0, pyr1, pts, valid, _ = _shift_case(dev)
    for n_levels, refine in ((3, 0), (1, 15), (0, 0)):
        kp, kok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, n_levels, refine_win=refine)
        pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, n_levels, refine_win=refine)
        assert torch.equal(kok, pok)
        assert (kp[kok] - pp[kok]).abs().max().item() < TIGHT_PX


def test_pyramid_matches_plain_and_truth(dev):
    """The level loop on the host over the one-level wrapper (refine pass
    included): five launches, agreement with the plain version, the known
    shift recovered (median error < 0.35 px, tests/test_klt_pallas.py's
    bound), and, being the same device code, ok identical to the fused
    launch's and positions within TIGHT_PX of it."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev)
    before = klt_cuda.lk_level.launches, klt_cuda.lk_pyramid.launches
    kp, kok = klt.lk_pyramid(klt_cuda.lk_level, pyr0, pyr1, pts, valid, 3, 15)
    torch.cuda.synchronize()
    assert (klt_cuda.lk_level.launches, klt_cuda.lk_pyramid.launches) == (before[0] + 5, before[1])
    pp, pok = klt.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert (kok == pok).float().mean().item() >= 0.99
    both = kok & pok
    assert both.sum().item() >= len(pts) - 10
    err = (kp[both] - pp[both]).abs().max().item()
    assert err < 0.05
    assert err < TIGHT_PX
    truth = pts + torch.tensor([dx, dy], device=dev)
    assert torch.linalg.norm(kp[kok] - truth[kok], dim=-1).median().item() < 0.35
    fp, fok = klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=15)
    assert torch.equal(kok, fok)
    assert (kp[kok] - fp[kok]).abs().max().item() < TIGHT_PX


def test_level_step_starts_from_the_given_guess(dev):
    """A level step from a guess that is not 0, on border points too: the
    search patch is cut around pos + guess as in the plain version."""
    pyr0, pyr1, pts, valid, (dx, dy) = _shift_case(dev, n_border=32)
    g0 = torch.tensor([dx - 0.8, dy + 0.6], device=dev).expand(len(pts), 2).contiguous()
    kg, kok = klt_cuda.lk_level(pyr0[0], pyr1[0], pts, g0, valid)
    pg, pok = klt.track_level(pyr0[0], pyr1[0], pts, g0, valid)
    assert torch.equal(kok, pok) and kok.sum().item() >= 90
    assert (kg[kok] - pg[kok]).abs().max().item() < TIGHT_PX
    assert torch.equal(kg[:4], g0[:4])  # an invalid feature keeps its guess


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    pyr0, pyr1, pts, valid, _ = _shift_case(dev, N=8)
    with pytest.raises(ValueError):
        klt_cuda.lk_level(pyr0[0].double(), pyr1[0].double(), pts.double(),
                          torch.zeros_like(pts).double(), valid)
    with pytest.raises(ValueError):
        klt_cuda.lk_level(pyr0[0], pyr1[0], pts.cpu(), torch.zeros_like(pts), valid)
    with pytest.raises(ValueError):  # a window wider than a thread's run of taps allows
        klt_cuda.lk_level(pyr0[0], pyr1[0], pts, torch.zeros_like(pts), valid, 43, 5)
    launches = klt_cuda.lk_pyramid.launches
    for bad in (
        ([x.double() for x in pyr0], [x.double() for x in pyr1], pts.double(), valid),  # float64
        (pyr0, pyr1, pts.cpu(), valid),  # pts on the CPU
        (pyr0, pyr1[:3] + [pyr1[3][:, :-1].contiguous()], pts, valid),  # level shapes differ
        ([pyr0[0].t().contiguous().t()] + pyr0[1:], pyr1, pts, valid),  # non-contiguous level
    ):
        with pytest.raises(ValueError, match="lk_pyramid"):
            klt_cuda.pyramidal_lk(*bad, 3, refine_win=15)
    with pytest.raises(ValueError, match="lk_pyramid"):  # the limit is the kernel's own
        klt_cuda.pyramidal_lk(pyr0, pyr1, pts, valid, 3, refine_win=300)
    # No feature: empty results, and no launch to count.
    none = klt_cuda.pyramidal_lk(pyr0, pyr1, pts[:0], valid[:0], 3, refine_win=15)
    assert none[0].shape == (0, 2) and none[1].shape == (0,)
    assert klt_cuda.lk_pyramid.launches == launches


def test_frontend_on_cuda_runs_through_the_kernel(dev):
    """The port's FrontEnd on the card tracks through the fused kernel: one
    launch per tracked frame, none of the one-level kernel."""
    from lfvio_tpu_torch.runtime import FrontEnd
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(), device=dev)
    fe = FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                  n_slots=160, annulus=(256, 192, SYN_MAX_R, SYN_MIN_R), device=dev)
    before = klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches
    outs = [fe.process_arrays(world.render(k / 15), k / 15) for k in range(3)]
    assert (klt_cuda.lk_pyramid.launches, klt_cuda.lk_level.launches) == (before[0] + 2, before[1])
    assert outs[2][4].sum() > 60


def _pal_frontend(dev, seed=0, n_slots=160):
    from lfvio_tpu_torch.runtime import FrontEnd
    from lfvio_tpu_torch.runtime.synthetic import (
        SYN_MAX_R, SYN_MIN_R, SyntheticWorld, make_synthetic_pal_camera)

    world = SyntheticWorld(camera=make_synthetic_pal_camera(), device=dev)
    return world, FrontEnd(world.camera, (world.height, world.width), max_cnt=120, min_dist=15,
                           n_slots=n_slots, annulus=(256, 192, SYN_MAX_R, SYN_MIN_R),
                           seed=seed, device=dev)


def test_dispatch_does_not_wait_and_equals_process_arrays(dev):
    """FrontEnd.dispatch enqueues and returns: behind a busy stream the
    handle's event has not completed when dispatch is back, so nothing in it
    waited for the card. Shown on an unpublished frame (CLAHE, pyramid, the
    LK kernel, the lift): a published frame's RANSAC calls
    torch.linalg.eigh and svd, whose error checks read the device. And
    dispatch + a later finalize gives what process_arrays gives, bit for
    bit, over 5 tracked frames (handles finalized two frames late, as the
    pipeline does at depth 3)."""
    world, fe_a = _pal_frontend(dev)
    _, fe_b = _pal_frontend(dev)
    imgs = [world.render(k / 15) for k in range(6)]
    torch.cuda.synchronize()
    publish = [k != 3 for k in range(6)]
    sync_outs = [fe_a.process_arrays(img, k / 15, publish=publish[k])
                 for k, img in enumerate(imgs)]
    handles, late_outs = [], []
    for k, img in enumerate(imgs):
        if not publish[k]:
            torch.cuda._sleep(int(2e8))  # keep the stream busy for ~0.1 s
        h = fe_b.dispatch(img, k / 15, publish=publish[k])
        if not publish[k]:
            assert h[1].event is not None and not h[1].event.query()
        handles.append(h)
        if len(handles) == 3:
            late_outs.append(fe_b.finalize(handles.pop(0)))
    late_outs += [fe_b.finalize(h) for h in handles]
    for a, b in zip(sync_outs, late_outs):
        assert (a is None) == (b is None)
        for x, y in zip(a or (), b or ()):
            np.testing.assert_array_equal(x, y)
    assert [o is None for o in late_outs] == [True, False, False, True, False, False]
    assert sync_outs[5][4].sum() > 60


def test_dual_frontend_counts_two_launches_a_frame(dev):
    """DualFrontEnd: two fused launches per tracked frame pair, one id space
    (no id handed out twice), a camera id per observation."""
    from lfvio_tpu_torch.runtime.tracker import DualFrontEnd

    world, fe0 = _pal_frontend(dev, n_slots=128)
    _, fe1 = _pal_frontend(dev, seed=1, n_slots=128)
    fe = DualFrontEnd(fe0, fe1)
    rics = [np.eye(3), np.diag([1.0, -1.0, -1.0])]
    tics = [np.array([0.0, 0.0, 0.05]), np.array([0.0, 0.0, -0.05])]
    before = klt_cuda.lk_pyramid.launches
    for k in range(4):
        out = fe.process_arrays(
            tuple(world.render_rig(k / 15, rics[c], tics[c]) for c in range(2)), k / 15)
    assert klt_cuda.lk_pyramid.launches == before + 2 * 3
    ids, bearings, vels, rows, pub, cams = out
    assert len(ids) == 256 and set(np.unique(cams)) == {0, 1}
    live = ids[ids >= 0]
    assert len(np.unique(live)) == len(live) > 100
    assert pub[cams == 0].sum() > 30 and pub[cams == 1].sum() > 30


# ------------------------------------------------------------- sym_eig
def _spread_spd(rng, B, n, dtype, dev):
    """B symmetric matrices with eigenvalues spread over [0, 1] (gaps of at
    least 1 / (n - 1): every eigenvector well posed) in random bases."""
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    lam = np.sort(np.linspace(0.0, 1.0, n) + 0.1 / n * rng.random((B, n)), axis=-1)
    A = Q @ (lam[..., None] * np.swapaxes(Q, -1, -2))
    return torch.as_tensor(A, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(256, 4), (101, 9), (101, 3)])
def test_sym_eig_matches_eigh(dev, shape, dtype, tol):
    """The main path's three shapes: eigenvalues ascending and within tol of
    the library's, every eigenvector parallel to the library's
    (|vᵀv_ref| within tol of 1) and unit length."""
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    B, n = shape
    A = _spread_spd(np.random.default_rng(n), B, n, dtype, dev)
    before = sym_eig.launches
    w, V = sym_eig(A)
    torch.cuda.synchronize()
    assert sym_eig.launches == before + 1
    w_ref, V_ref = torch.linalg.eigh(A)
    assert float((w - w_ref).abs().max()) <= tol
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    dots = (V * V_ref).sum(-2).abs()
    assert float((dots - 1).abs().max()) <= 10 * tol
    assert float((V.norm(dim=-2) - 1).abs().max()) <= 10 * tol


def test_sym_eig_wrapper(dev):
    """Batch shapes pass through, a rank-deficient matrix gives its null
    vector, an empty batch launches nothing, and what the kernel does not
    take raises (no library fallback)."""
    from lfvio_tpu_torch.geom.eigh_cuda import sym_eig

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((2, 3, 8, 9)), device=dev)
    w, V = sym_eig(X.transpose(-1, -2) @ X)  # rank 8: one null vector each
    assert w.shape == (2, 3, 9) and V.shape == (2, 3, 9, 9)
    null = V[..., :, 0]
    assert float((X @ null[..., :, None]).abs().max()) <= 1e-10
    before = sym_eig.launches
    w0, V0 = sym_eig(torch.zeros((0, 4, 4), device=dev))
    assert w0.shape == (0, 4) and sym_eig.launches == before
    for bad in (torch.zeros((3, 10, 10), device=dev), torch.zeros((3, 4, 4), dtype=torch.int32,
                                                                   device=dev),
                torch.zeros((3, 4, 5), device=dev)):
        with pytest.raises(ValueError):
            sym_eig(bad)


def test_published_dispatch_does_not_wait(dev):
    """A published frame's dispatch (RANSAC's eigensolves now the kernel)
    enqueues and returns behind a busy stream: its event has not completed
    when dispatch is back, and no call in it is a synchronizing one."""
    world, fe = _pal_frontend(dev)
    imgs = [world.render(k / 15) for k in range(3)]
    fe.process_arrays(imgs[0], 0.0)
    fe.process_arrays(imgs[1], 1 / 15)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = fe.dispatch(imgs[2], 2 / 15, publish=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert h[1].event is not None and not h[1].event.query()
    assert fe.finalize(h)[4].sum() > 60


def test_estimator_graphs_match_eager_f64(dev):
    """One replay of each program's CUDA graph (solve, relocalization solve,
    both marginalizations) against the same function run eagerly on the
    same inputs, f64, within 1e-9 of the scale (chip_smoke.py phase 14)."""
    import chip_smoke

    errs = chip_smoke.phase_graphs_f64(dev)
    assert set(errs) == {"solve", "marg_old", "marg_new", "relo"}
    assert max(errs.values()) <= 1e-9
