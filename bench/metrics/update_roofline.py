"""The fused update kernel's share of its HBM roofline: the bytes every
client's plain-SGD update of the profiled steps must move
(``flops.update_bytes``) at 3.35 TB/s, over the device time of the
``fused_sgd_update`` kernels."""
from bench import flops

name = "update_roofline"
unit = "%"
layer = "kernels/fused_update"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024", "musicgen-medium.train.crop30s"]


def read(rec):
    n, ms = rec.kernel_ms(("fused_sgd_update",), rec.step_kernels())
    if not n or ms <= 0 or not rec.update_leaves:
        return None
    updates = rec.traffic["clients"] * rec.n_steps
    bound_s = updates * flops.update_bytes(rec.update_leaves) \
        / flops.PEAK_HBM_BYTES
    return 100.0 * bound_s * 1e3 / ms
