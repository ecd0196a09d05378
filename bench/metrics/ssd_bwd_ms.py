"""Device milliseconds a local step under the program's ``ssd.backward``
range (the SSD Function's backward, whatever implements it)."""
name = "ssd_bwd_ms"
unit = "ms"
layer = "kernels/ssd"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024"]


def read(rec):
    ms = rec.range_ms.get("ssd.backward", 0.0)
    return ms / rec.n_steps if ms > 0 and rec.n_steps else None
