"""The SSD forward kernels' share of their roofline: the least time of
the calls' work (``flops.ssd_fwd_bound_s`` at one client's batch, a call
for each launch of the chunk kernel) over the device time of the SSD
kernels (``ssd_cb_kernel``, ``ssd_chunk_kernel``)."""
from bench import flops

name = "ssd_fwd_roofline"
unit = "%"
layer = "kernels/ssd"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024"]


def read(rec):
    calls, _ = rec.kernel_ms(("ssd_chunk_kernel",))
    n, ms = rec.kernel_ms(("ssd_cb_kernel", "ssd_chunk_kernel"))
    if not calls or ms <= 0:
        return None
    t = rec.traffic
    bound_s = calls * flops.ssd_fwd_bound_s(rec.model, t["rows_per_client"],
                                            t["tokens_per_row"])
    return 100.0 * bound_s * 1e3 / ms
