"""Data, tensor and spatial parallelism on ``torch.distributed``: one
process a device (``spatial``'s in-process transport serves a
``Predictor`` over local devices)."""

from two_stage_object_detection_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, replicate, shard_batch)
from two_stage_object_detection_tpu_torch.parallel.multiprocess import (  # noqa: F401
    fetch_global, init_distributed, is_multiprocess, put_global, put_local)
