"""The whole step's share of the chip's bf16 peak: the model FLOPs of the
traced run's local steps outside the profiled stretch
(``flops.train_step_flops``: 6 a matmul parameter a position, frames
included, and the attention or SSD terms; no remat recompute) over their
wall, rounds included, times 989 TFLOP/s. The profiled steps are left
out: the profiler slows the host's side of a step."""
from bench import flops
from bench.data import frames

name = "mfu"
unit = "%"
layer = "whole step"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024", "musicgen-medium.train.crop30s"]


def read(rec):
    if rec.free_steps < 1 or rec.free_wall_s <= 0:
        return None
    t = rec.traffic
    f = flops.train_step_flops(rec.model, t["clients"] * t["rows_per_client"],
                               t["tokens_per_row"], frames(rec.model, t))
    return 100.0 * f * rec.free_steps / (rec.free_wall_s
                                         * flops.PEAK_BF16_FLOPS)
