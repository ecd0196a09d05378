"""Hopper kernels of the port, each beside its plain PyTorch version.

Every wrapper below counts its launches in a plain integer attribute
(``wrapper.launches``), so a run can show that its path went through the
kernels. The CUDA sources live in ``csrc/``; ``build.library()`` builds and
loads them at first use. The flash-attention wrapper is reached as
``kernels.flash_attention.kernel.flash_attention`` (the subpackage keeps
its name here).
"""
from repro_torch.kernels.flash_attention import kernel as _flash
from repro_torch.kernels.fused_update.kernel import fused_sgd_update
from repro_torch.kernels.quantize.kernel import (dequant_mean_kernel,
                                                quantize_kernel)

KERNELS = (fused_sgd_update, quantize_kernel, dequant_mean_kernel,
           _flash.flash_attention)


def launch_counts() -> dict:
    """{wrapper name: launches so far}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "dequant_mean_kernel", "fused_sgd_update",
           "launch_counts", "quantize_kernel", "reset_launch_counts"]
