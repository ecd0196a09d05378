"""Milliseconds of a dense round: the harness's span around each
``sync_step`` call in the window, synchronised at both ends (the driver's
own ``reduce`` span times only the enqueue); the median of the window's
rounds."""
import statistics

name = "round_ms"
unit = "ms"
layer = "driver round: core/stl_sgd -> local_sgd.build_sync_step"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024", "musicgen-medium.train.crop30s"]


def read(rec):
    return statistics.median(rec.round_ms) if rec.round_ms else None
