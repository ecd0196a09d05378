from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                quantize_kernel)
from repro_torch.kernels.quantize.ops import (compute_scale, decode_mean_leaf,
                                             dequant_mean, encode_leaf,
                                             qmax_for, quantize)
from repro_torch.kernels.quantize.ref import dequant_mean_ref, quantize_ref

__all__ = ["compute_scale", "decode_mean_leaf", "dequant_mean",
           "dequant_mean_kernel", "dequant_mean_ref", "encode_leaf",
           "qmax_for", "quantize", "quantize_kernel", "quantize_ref"]
