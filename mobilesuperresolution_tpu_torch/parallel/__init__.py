from mobilesuperresolution_tpu_torch.parallel.distributed import initialize_from_params, is_primary
from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr, spatially_sharded_apply
from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from mobilesuperresolution_tpu_torch.parallel.temporal import chunked_vsr_apply

__all__ = ["Mesh", "chunked_vsr_apply", "initialize_from_params", "is_primary", "make_mesh", "receptive_radius_wdsr",
           "shard_batch", "spatially_sharded_apply"]

# spatial_train and vsr_spatial pull in the train steps and the models; they
# are imported from their modules (core/device.py imports this package)
