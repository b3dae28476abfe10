"""The port's bearing-level harness (``chip_smoke.py``'s, a copy of
``tests/_bearing_harness.py`` that imports no JAX), usable with either
package's pipeline: a stub front end serves analytic bearings of known
landmarks and exact IMU goes through the real measurement-alignment path,
so a stream isolates the back end. ``run_both`` drives one named stream
through the JAX pipeline and the port's (on the CPU, f64) and caches the
pair."""

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import (  # noqa: F401  (re-exported to the test files)
    BearingFrontEnd,
    cam_bearings,
    make_landmarks,
    run_bearing_stream as run_stream,
)
from lfvio_tpu.runtime.estimator import Estimator as JEstimator, EstimatorConfig as JConfig
from lfvio_tpu.runtime.pipeline import VioPipeline as JPipeline
from lfvio_tpu.runtime.synthetic import SyntheticWorld as JWorld, make_synthetic_pal_camera as j_cam

from lfvio_tpu_torch.runtime import synthetic as tsyn
from lfvio_tpu_torch.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu_torch.runtime.pipeline import VioPipeline

F64 = torch.float64


class DispatchingBearingFrontEnd(BearingFrontEnd):
    """The same stub behind the dispatch / finalize interface, so that the
    pipelines run their depth-N path (in-flight and deferred frame queues)."""

    def dispatch(self, img, t, publish=True):
        return ("stub", None, (np.zeros(1),), t, publish)

    def finalize(self, handle, host_outs=None):
        return self.process_arrays(None, handle[3], handle[4])


def make_worlds():
    return (JWorld(camera=j_cam(dtype=jnp.float64)),
            tsyn.SyntheticWorld(camera=tsyn.make_synthetic_pal_camera(dtype=F64), dtype=F64,
                                device="cpu"))


# ------------------------------------------------------------------ streams
STREAMS = {
    "lag1": dict(cfg=dict(solve_lag=1)),
    "lag2_chain": dict(cfg=dict(solve_lag=2, device_chain=True)),
    "lag2_mirrors": dict(cfg=dict(solve_lag=2, device_chain=False)),
    "lag3": dict(cfg=dict(solve_lag=3)),
    "td": dict(cfg=dict(solve_lag=1, estimate_td=True), td_true=0.005, traj_freq=0.8),
    "depth3_throttled": dict(cfg=dict(solve_lag=2), dispatching=True, freq=10.0, duration=2.6),
}
_runs = {}


def run_both(key, worlds):
    """The stream ``key`` through the JAX pipeline and the port's (cached)."""
    if key in _runs:
        return _runs[key]
    spec = STREAMS[key]
    jw, tw = worlds
    if "traj_freq" in spec:
        jw = JWorld(camera=jw.camera, traj_freq=spec["traj_freq"])
        tw = tsyn.SyntheticWorld(camera=tw.camera, traj_freq=spec["traj_freq"], dtype=F64,
                                 device="cpu")
    pts = make_landmarks()
    fe_cls = DispatchingBearingFrontEnd if spec.get("dispatching") else BearingFrontEnd
    pkw = dict(freq=spec.get("freq", 0.0))
    jest = JEstimator(JConfig(n_feature_slots=64, solver_dtype=jnp.float64, **spec["cfg"]))
    test = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=F64, device="cpu",
                                     **spec["cfg"]))
    dur = spec.get("duration", 1.5)
    jp = run_stream(JPipeline(fe_cls(jw, pts, td_true=spec.get("td_true", 0.0)), jest, **pkw),
                    jw, dur)
    tp = run_stream(VioPipeline(fe_cls(tw, pts, td_true=spec.get("td_true", 0.0)), test, **pkw),
                    tw, dur)
    _runs[key] = (jest, test, jp, tp, jw, tw, pts)
    return _runs[key]


