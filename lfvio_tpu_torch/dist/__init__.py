"""Sharded estimation over ``torch.distributed`` (port of ``lfvio_tpu.dist``):
the feature axis and the keyframe axis."""

from .sharding import (
    FeatureMesh,
    gather_features,
    lm_solve_sharded,
    make_feature_mesh,
    shard_features,
    shard_grid,
)
from .marginalize import marginalize_old_qr_sharded
from .frame_step import triangulate_sharded, vio_frame_step_sharded
from .kf_axis import KfMesh, make_kf_mesh, segmented_trajectory_solve
