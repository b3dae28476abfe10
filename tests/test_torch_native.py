"""The port's native IO runtime (``lfvio_tpu_torch.native``) against the JAX
package's bindings (``lfvio_tpu.native``): the same pushes give identical
pops (frame times and ids, and the dt / acc / gyr arrays bit for bit),
identical restart flags and byte-identical TUM files. The port builds its
own copy of io_runtime.cpp into lfvio_tpu_torch/build/, keyed by a hash of
the source.
"""

import numpy as np
import pytest

from lfvio_tpu_torch import native as tnative

jnative = pytest.importorskip("lfvio_tpu.native")


def test_builds_into_the_build_directory():
    lib = tnative.build()
    assert lib.parent == tnative.BUILD_DIR and lib.name.startswith("libioruntime_")
    assert tnative.build() == lib  # a second call finds it
    assert tnative.load() is tnative.load()


def drive(mod, td):
    """A jittered 200 Hz IMU stream with 20 Hz frames (one restart gap),
    pushed and popped as a pipeline would; returns every event."""
    rng = np.random.default_rng(4)
    sync = mod.NativeSynchronizer(td=td)
    events = []
    t_imu = np.cumsum(rng.uniform(0.004, 0.006, 300))
    t_frames = list(np.arange(0.05, 1.2, 0.05)) + [2.5, 2.55]
    k = 0
    for tf in t_frames:
        while k < len(t_imu) and t_imu[k] <= tf + 0.02:
            sync.push_imu(t_imu[k], rng.standard_normal(3), rng.standard_normal(3))
            k += 1
        events.append(("restart", sync.push_frame(tf, int(tf * 1000))))
        while (out := sync.pop()) is not None:
            events.append(("pop", *out))
    return events


@pytest.mark.parametrize("td", [0.0, 0.004])
def test_synchronizer_matches_jax_bindings(td):
    a, b = drive(jnative, td), drive(tnative, td)
    assert len(a) == len(b) and sum(e[0] == "pop" for e in a) > 10
    for ea, eb in zip(a, b):
        assert ea[0] == eb[0] and ea[1:3] == eb[1:3]
        for x, y in zip(ea[3:], eb[3:]):
            assert np.array_equal(x, y)


def test_tum_writer_matches_jax_bindings(tmp_path):
    rng = np.random.default_rng(5)
    rows = [(float(t), rng.standard_normal(3), rng.standard_normal(4)) for t in np.arange(7) * 0.1]
    for mod, name in ((jnative, "jax.txt"), (tnative, "port.txt")):
        w = mod.NativeTumWriter(str(tmp_path / name))
        for r in rows:
            w.write(*r)
        w.close()
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    with pytest.raises(ValueError):
        with tnative.NativeTumWriter(str(tmp_path / "bad.txt")) as w:
            w.write(0.0, [1.0, 2.0], [1.0, 0, 0, 0])
