"""Device milliseconds of cuBLAS's GEMM kernels a local step, by kernel
name (the products of the plain backwards among them)."""
from bench.trace import GEMM_KERNELS

name = "gemm_ms_per_step"
unit = "ms"
layer = "local step: core/local_sgd.build_train_steps"
moves = "train_tokens_per_s"
workloads = ["mamba2-2.7b.train.s1024", "musicgen-medium.train.crop30s"]


def read(rec):
    n, ms = rec.kernel_ms(GEMM_KERNELS)
    return ms / rec.n_steps if n and rec.n_steps else None
