from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr
from mobilesuperresolution_tpu_torch.parallel.temporal import chunked_vsr_apply

__all__ = ["chunked_vsr_apply", "receptive_radius_wdsr"]
