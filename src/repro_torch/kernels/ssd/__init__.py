from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_ref

__all__ = ["ssd", "ssd_chunked_ref", "ssd_ref"]
