"""The port's parallel layer over ``torch.distributed`` (the reference's
``points_matching_tpu/parallel``): collectives, named process-group meshes,
the all-pairs ring, GPipe stages and sharded bundle adjustment."""
from points_matching_tpu_torch.parallel.comm import Comm, set_fault_hook  # noqa: F401
from points_matching_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    host_local_to_global,
    initialize_distributed,
    make_mesh,
    replicated,
    shard,
)
from points_matching_tpu_torch.parallel.all_pairs import all_pairs_scores  # noqa: F401
from points_matching_tpu_torch.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS,
    pipeline_stages,
)
from points_matching_tpu_torch.parallel.sharded_ba import (  # noqa: F401
    distributed_bundle_adjust,
    shard_ba_state,
)
