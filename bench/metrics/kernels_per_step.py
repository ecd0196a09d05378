"""Device kernels a local step: the profiled stretch's kernels outside
the round, over its local steps."""
name = "kernels_per_step"
unit = "count"
layer = "local step: core/local_sgd.build_train_steps"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024", "musicgen-medium.train.crop30s"]


def read(rec):
    n = len(rec.step_kernels())
    return n / rec.n_steps if n and rec.n_steps else None
