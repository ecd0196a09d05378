"""Device milliseconds a local step under the program's
``flash_attention.backward`` range (the attention Function's backward,
whatever implements it)."""
name = "attn_bwd_ms"
unit = "ms"
layer = "kernels/flash_attention"
moves = "train_tokens_per_s"
workloads = ["musicgen-medium.train.crop30s"]


def read(rec):
    ms = rec.range_ms.get("flash_attention.backward", 0.0)
    return ms / rec.n_steps if ms > 0 and rec.n_steps else None
