"""Quantize inputs on the kernel's edges, made with numpy from a seed.

Shared by the CPU parity tests (the port against the JAX package) and the
JAX-free GPU tests (the CUDA kernel against the plain version). Each
function returns ``(y, words, s)``: float32 (N, M) deltas, uint32 (N, M)
random words and float32 (N,) per-row scales.
"""
import numpy as np

EDGE_CASES = ("integer", "clip", "zero", "top_words", "half")


def qmax_for(bits: int) -> np.float32:
    return np.float32(2 ** (bits - 1) - 1)


def random_inputs(N: int, M: int, seed: int = 0):
    """Row-scaled normal deltas, uniform words, scales max|y| per row; the
    first row's first words sit at the top of the range (u = 1.0)."""
    rng = np.random.RandomState(seed)
    y = (rng.randn(N, M) * rng.rand(N, 1)).astype(np.float32)
    words = rng.randint(0, 2 ** 32, size=(N, M), dtype=np.uint64) \
        .astype(np.uint32)
    words[0, :8] = 2 ** 32 - 1 - np.arange(min(M, 8)) * 40
    s = np.maximum(np.abs(y).max(axis=1), 1e-12).astype(np.float32)
    return y, words, s


def edge_inputs(case: str, bits: int, M: int = 260, seed: int = 0):
    """Three rows (scales 1, 0.75 and 3e-3) whose deltas or words sit on
    one edge of the rounding:

    * ``integer``: y / s * qmax is exactly an integer k in [-qmax, qmax]
      (in float32, each operation rounded) and u = 0, so floor() sits on
      its boundary;
    * ``clip``: y = +-s and the float32 neighbours inside, with random
      words: the codes reach +-qmax and must clip there;
    * ``zero``: y = -0.0 and +0.0, with words 0, 1 << 31 and the top;
    * ``top_words``: words from 2^32 - 256 to 2^32 - 1 (u = 1.0 from
      2^32 - 128 on);
    * ``half``: every word 1 << 31 (u = 0.5, the non-stochastic round).
    """
    rng = np.random.RandomState(seed)
    q = qmax_for(bits)
    s = np.array([1.0, 0.75, 3e-3], np.float32)
    N = len(s)
    y = (rng.uniform(-1.0, 1.0, (N, M)) * s[:, None]).astype(np.float32)
    words = rng.randint(0, 2 ** 32, size=(N, M), dtype=np.uint64) \
        .astype(np.uint32)
    col = np.arange(M)
    if case == "integer":
        k = np.broadcast_to((col % (2 * int(q) + 1) - q).astype(np.float32),
                            (N, M))
        y = s[:, None] * k / q
        # a y whose quotient misses k by a rounding: the float32 neighbours
        # nearest to it that hit k, else 0
        for _ in range(4):
            miss = (y / s[:, None]) * q != k
            if not miss.any():
                break
            up = np.nextafter(y, np.float32(np.inf))
            down = np.nextafter(y, np.float32(-np.inf))
            y = np.where(miss & ((up / s[:, None]) * q == k), up, y)
            miss = (y / s[:, None]) * q != k
            y = np.where(miss & ((down / s[:, None]) * q == k), down, y)
        y = np.where((y / s[:, None]) * q == k, y, np.float32(0.0))
        words[:] = 0
    elif case == "clip":
        edge = np.stack([s, np.nextafter(s, np.float32(0.0))], axis=1)
        y = (edge[:, col % 2] * np.where(col % 4 < 2, 1.0, -1.0)) \
            .astype(np.float32)
        words[:, ::3] = 2 ** 32 - 1
    elif case == "zero":
        y = np.where(col % 2 == 0, np.float32(-0.0), np.float32(0.0)) \
            * np.ones((N, 1), np.float32)
        words[:, 0::3] = 0
        words[:, 1::3] = 1 << 31
        words[:, 2::3] = 2 ** 32 - 1
    elif case == "top_words":
        words[:] = (2 ** 32 - 1 - col % 256).astype(np.uint32)
    elif case == "half":
        words[:] = 1 << 31
    else:
        raise ValueError(case)
    return np.ascontiguousarray(y, np.float32), words, s
