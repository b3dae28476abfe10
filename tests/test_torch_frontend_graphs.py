"""The FrontEnd's per-frame programs on the CPU.

A tracked frame runs ``FrontEnd._step_impl`` as one program (on the card a
CUDA graph, one for published and one for unpublished frames; on the CPU
``device.DeviceProgram`` calls the function as it is). ``dispatch`` draws
RANSAC's uniforms outside the program, on published frames only, from the
FrontEnd's generator in frame order, and hands them to the step, as the
JAX step takes its key. These tests hold that order, the step with the
draws passed in against ``dispatch``, and the image upload's forms; the
parity tests against the JAX FrontEnd (``tests/test_torch_pipeline.py``,
``test_torch_frontend_configs.py``, ``test_torch_multicam.py``) run the same
code. The graphs themselves are held against the op-by-op step on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from lfvio_tpu_torch.device import DeviceProgram
from lfvio_tpu_torch.frontend.ransac import N_HYPOTHESES
from lfvio_tpu_torch.runtime import synthetic as tsyn
from lfvio_tpu_torch.runtime.tracker import DualFrontEnd, FrontEnd

torch.set_num_threads(1)

# Publish patterns over the frames of a stream (frame 0 is the first frame):
# the bench's 15 Hz frames published at 10 Hz (every other frame), and 30 Hz
# frames published at 10 Hz (2 of 3 unpublished).
PATTERNS = {"15hz_10hz": [k % 2 == 0 for k in range(9)],
            "30hz_10hz": [k % 3 == 0 for k in range(9)]}


@pytest.fixture(scope="module")
def world():
    return tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=torch.float32),
                               dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def frames(world):
    return [world.render_u8(k / 15.0) for k in range(9)]


def _frontend(world, seed=0, **kw):
    args = dict(max_cnt=80, min_dist=15, n_slots=96, equalize=True, dtype=torch.float32,
                annulus=(world.width / 2, world.height / 2, tsyn.SYN_MAX_R, tsyn.SYN_MIN_R),
                seed=seed, device="cpu")
    args.update(kw)
    return FrontEnd(world.camera, (world.height, world.width), **args)


def _record_draws(fe):
    """Wrap the FrontEnd's step (before its programs are made, which bind
    it) so that the draws each call is handed are recorded."""
    seen, step = [], fe._step_impl

    def recorded(pyr_prev, img, pos, valid, draws, publish):
        seen.append((publish, None if draws is None else draws.clone()))
        return step(pyr_prev, img, pos, valid, draws, publish)

    fe._step_impl = recorded
    return seen


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_dispatch_draws_ransac_uniforms_on_published_frames_only(world, frames, pattern):
    """One [N_HYPOTHESES, N] draw a published tracked frame, none on an
    unpublished one or the first frame, in frame order from the seeded
    generator: the sequence the step drew itself before it took the draws
    as an argument. The generator ends where that sequence leaves it."""
    publish = PATTERNS[pattern]
    fe = _frontend(world, seed=3)
    seen = _record_draws(fe)
    for k, img in enumerate(frames):
        fe.finalize(fe.dispatch(img, k / 15.0, publish=publish[k]))
    ref = torch.Generator().manual_seed(3)
    assert [p for p, _ in seen] == publish[1:]
    for pub, draws in seen:
        if not pub:
            assert draws is None
            continue
        want = torch.rand((N_HYPOTHESES, fe.N), generator=ref, dtype=torch.float32)
        assert torch.equal(draws, want)
    assert torch.equal(fe.generator.get_state(), ref.get_state())


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_step_with_draws_passed_in_equals_dispatch(world, frames, pattern):
    """The step called by hand with ``ransac_draws()`` drawn just before it
    on published frames (the former order: one draw inside each published
    step) gives what ``dispatch`` fetches, bit for bit, and both chains
    advance alike, over 8 tracked frames."""
    publish = PATTERNS[pattern]
    fe_a, fe_b = _frontend(world), _frontend(world)
    for k, img in enumerate(frames):
        h = fe_a.dispatch(img, k / 15.0, publish=publish[k])
        if k == 0:
            fe_b.process_arrays(img, 0.0)
            fe_a.finalize(h)
            continue
        draws = fe_b.ransac_draws() if publish[k] else None
        pyr, status, new_src, pos_next, bear_next, valid_next = fe_b._step_impl(
            fe_b.prev_pyr, img, fe_b._dev_pos, fe_b._dev_valid, draws, publish=publish[k])
        fe_b.prev_pyr, fe_b._dev_pos, fe_b._dev_valid = pyr, pos_next, valid_next
        for x, y in zip(h[1].numpy(), (status, new_src, pos_next, bear_next)):
            np.testing.assert_array_equal(x, y.numpy())
        fe_a.finalize(h)
        assert torch.equal(fe_a._dev_valid, fe_b._dev_valid)
    assert int(fe_a._dev_valid.sum()) > 40


def test_use_graphs_off_runs_the_same_step(world, frames):
    """``use_graphs = False`` runs the step op by op and makes no program;
    on the CPU the programs call the same function, so the two give the
    same frames bit for bit, a ``reset`` mid-stream included."""
    fe_g, fe_e = _frontend(world), _frontend(world)
    fe_e.use_graphs = False
    publish = PATTERNS["15hz_10hz"]
    for k, img in enumerate(frames):
        if k == 5:
            fe_g.reset()
            fe_e.reset()
        outs = [fe.finalize(fe.dispatch(img, k / 15.0, publish=publish[k]))
                for fe in (fe_g, fe_e)]
        assert (outs[0] is None) == (outs[1] is None)
        for x, y in zip(outs[0] or (), outs[1] or ()):
            np.testing.assert_array_equal(x, y)
    assert set(fe_g._programs) == {True, False} and fe_e._programs == {}
    assert all(isinstance(p, DeviceProgram) and p.graph is None and p.replays == 0
               for p in fe_g._programs.values())
    assert fe_g.graph_stats() == (0, 0.0)


def test_host_and_device_images_give_the_same_frames(world, frames):
    """A numpy frame and the same frame as a tensor give the same results;
    a float image the step's dtype, unequalized, is not kept as the
    pyramid's level 0 (the next frame's image takes its buffer)."""
    fe_n, fe_t = _frontend(world), _frontend(world)
    for k, img in enumerate(frames[:4]):
        a = fe_n.process_arrays(img.numpy(), k / 15.0)
        b = fe_t.process_arrays(img, k / 15.0)
        for x, y in zip(a or (), b or ()):
            np.testing.assert_array_equal(x, y)
    fe = _frontend(world, equalize=False)
    img = frames[0].to(torch.float32)
    pyr = fe._preprocess(img)
    assert pyr[0] is not img and pyr[0].data_ptr() != img.data_ptr()
    assert torch.equal(pyr[0], img)


def test_dual_frontend_cameras_have_programs_of_their_own(world, frames):
    """Each camera's FrontEnd of a DualFrontEnd makes its own programs, as
    JAX runs one tracker program a camera, and the rig's frames equal those
    of the two FrontEnds driven apart."""
    fes = [_frontend(world, seed=c) for c in range(2)]
    dual = DualFrontEnd(*fes)
    alone = [_frontend(world, seed=c) for c in range(2)]
    alone[1]._ids_src = alone[0]._ids_src
    for k, img in enumerate(frames[:4]):
        pair = (img, torch.flip(img, dims=(1,)))
        out = dual.process_arrays(pair, k / 15.0)
        ref = [fe.process_arrays(im, k / 15.0) for fe, im in zip(alone, pair)]
        if k:
            for i in range(5):
                np.testing.assert_array_equal(out[i], np.concatenate([r[i] for r in ref]))
    assert fes[0]._programs[True] is not fes[1]._programs[True]
    assert fes[0]._programs[True].fn.func.__self__ is fes[0]
