"""The flash-attention forward kernel's share of its roofline: the least
time of the calls' causal work (``flops.flash_fwd_bound_s`` at one
client's batch of frames and tokens, a call a launch) over the device
time of the ``flash_fwd`` kernels."""
from bench import flops
from bench.data import frames

name = "flash_fwd_roofline"
unit = "%"
layer = "kernels/flash_attention"
moves = "train_tokens_per_s"
workloads = ["musicgen-medium.train.crop30s"]


def read(rec):
    calls, ms = rec.kernel_ms(("flash_fwd",))
    if not calls or ms <= 0:
        return None
    t = rec.traffic
    S = t["tokens_per_row"] + frames(rec.model, t)
    bound_s = calls * flops.flash_fwd_bound_s(rec.model,
                                              t["rows_per_client"], S)
    return 100.0 * bound_s * 1e3 / ms
