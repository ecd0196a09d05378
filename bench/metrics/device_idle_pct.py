"""The share of a local step's wall in which no kernel runs. Busy a step:
the union of the kernels' intervals in the profiled stretch's local steps,
a step, plus the busy time of the stretch's round times the rounds a step
of the rest of the window. Wall a step: the traced run's window outside
the stretch, rounds included, over its local steps (the profiler slows
the host's side of a step, not the kernels)."""
name = "device_idle_pct"
unit = "%"
layer = "device"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024", "musicgen-medium.train.crop30s"]


def read(rec):
    if (rec.busy_s <= 0 or rec.free_steps < 1 or rec.free_wall_s <= 0
            or not rec.round_spans):
        return None
    rnd = rec.round_busy_s()
    busy = ((rec.busy_s - rnd) / rec.n_steps
            + rnd / len(rec.round_spans) * rec.free_rounds / rec.free_steps)
    return 100.0 * (1.0 - busy / (rec.free_wall_s / rec.free_steps))
