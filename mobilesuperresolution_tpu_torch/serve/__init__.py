from mobilesuperresolution_tpu_torch.serve.flow_cache import FlowCachedStreamingVSR, make_flow_sr_fns
from mobilesuperresolution_tpu_torch.serve.streaming import StreamingVSR

__all__ = ["FlowCachedStreamingVSR", "StreamingVSR", "make_flow_sr_fns"]
