"""Feature-sharded estimation over ``torch.distributed`` (port of the
feature axis of ``lfvio_tpu.dist``)."""

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
