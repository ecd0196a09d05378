"""The SSD kernel's precision scheme, emulated on the CPU.

``kernels/csrc/ssd.cu`` runs every product of the chunked scan on the
tensor cores as three bf16 products: a = ah + al with ah = bf16(a) and
al = bf16(a - ah), and a·b ≈ al·bh + ah·bl + ah·bh with float32 sums. This
file repeats the kernel's chunked form with each product emulated that way
(a test-local copy of the passes, not the port's code) and holds it against
the exact recurrence in float64, at the JAX package's float32 tolerance of
``tests/test_ssd_kernel.py`` (|d| <= 3e-4 + 3e-4 |ref|, on y and the final
state). The scheme must use at most a tenth of it. As a control, the same
form with one TF32 product (each factor's mantissa cut to 10 bits) must
show at least ten times the scheme's error, so the check can tell the
schemes apart.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd.ref import ssd_ref

TOL = 3e-4   # the float32 tolerance of the JAX package's SSD tests

# (b, S, H, P, G, N, chunk): mamba2-2.7b's state width at its chunk, and
# the Pallas test's grouped shape
SHAPES = {
    "n128": (1, 1024, 4, 64, 1, 128, 256),
    "g2_n32": (2, 256, 4, 64, 2, 32, 64),
}


def _inputs(b, S, H, P, G, N, seed=0):
    """chip_smoke.py phase 8's input distribution, from numpy."""
    rng = np.random.default_rng(seed)
    rn = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    x = rn(b, S, H, P) * 0.5
    dt = torch.nn.functional.softplus(rn(b, S, H)) * 0.1
    A = -torch.exp(rn(H) * 0.3)
    return x, dt, A, rn(b, S, G, N) * 0.3, rn(b, S, G, N) * 0.3


def _recurrence64(x, dt, A, B, C):
    """The exact recurrence (``ssd_ref``'s) in float64."""
    b, S, H, P = x.shape
    rep = H // B.shape[2]
    Bh = B.double().repeat_interleave(rep, dim=2)
    Ch = C.double().repeat_interleave(rep, dim=2)
    xd, dtd, Ad = x.double(), dt.double(), A.double()
    h = torch.zeros((b, H, P, B.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dtd[:, t] * Ad)[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xd[:, t] * dtd[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h


def _bf16(t):
    return t.to(torch.bfloat16).float()


def split3(a, b):
    """a @ b as the kernel forms it: al bh + ah bl + ah bh, float32 sums
    (each partial product of two bf16 values is exact in float32)."""
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tf32_once(a, b):
    """a @ b with one TF32 product: each factor's mantissa cut to 10 bits."""
    cut = lambda t: (t.contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return cut(a) @ cut(b)


def chunked(x, dt, A, B, C, chunk, prod):
    """The kernel's passes with every product formed by ``prod``: C·Bᵀ per
    chunk; each chunk's state (the decay weights on B's rows); state
    passing in float32; the outputs (the state term scaled by exp(cums)
    after its product, the decayed C·Bᵀ tile formed in float32 before
    its product). S a multiple of the chunk here."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, Q = S // chunk, chunk
    rep = H // G
    xs = x.reshape(b, nc, Q, H, P).permute(0, 1, 3, 2, 4)     # b nc H Q P
    dts = dt.reshape(b, nc, Q, H).permute(0, 1, 3, 2)         # b nc H Q
    Bs = B.reshape(b, nc, Q, G, N).permute(0, 1, 3, 2, 4)     # b nc G Q N
    Cs = C.reshape(b, nc, Q, G, N).permute(0, 1, 3, 2, 4)
    cums = torch.cumsum(dts * A[:, None], dim=-1)             # b nc H Q
    cb = prod(Cs, Bs.transpose(-1, -2)).repeat_interleave(rep, dim=2)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(cums[..., :, None] - cums[..., None, :]),
                    torch.zeros(()))
    xdt = xs * dts[..., None]
    y = prod(cb * L, xdt)                                     # b nc H Q P
    w = torch.exp(cums[..., -1:] - cums)                      # b nc H Q
    Bh = Bs.repeat_interleave(rep, dim=2)
    Ch = Cs.repeat_interleave(rep, dim=2)
    s_c = prod(xdt.transpose(-1, -2), Bh * w[..., None])     # b nc H P N
    state = torch.zeros((b, H, P, N))
    for c in range(nc):
        if c:
            y[:, c] += torch.exp(cums[:, c])[..., None] * prod(
                Ch[:, c], state.transpose(-1, -2))
        state = state * torch.exp(cums[:, c, :, -1])[..., None, None] \
            + s_c[:, c]
    return y.permute(0, 1, 3, 2, 4).reshape(b, S, H, P), state


def share_of_tol(got, ref):
    """Worst |got - ref| / (TOL + TOL |ref|) over y and the final state."""
    return max(float(((g.double() - r).abs() / (TOL + TOL * r.abs())).max())
               for g, r in zip(got, ref))


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (b, S, H, P, G, N, chunk) in SHAPES.items():
        args = _inputs(b, S, H, P, G, N)
        out[name] = (args, chunk, _recurrence64(*args))
    return out


def test_float64_recurrence_is_ssd_ref(cases):
    args, _, (y64, s64) = cases["g2_n32"]
    y, s = ssd_ref(*args)
    assert float((y.double() - y64).abs().max()) < 1e-5
    assert float((s.double() - s64).abs().max()) < 1e-5


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_split_scheme_holds_a_tenth_of_the_tolerance(cases, name):
    args, chunk, ref = cases[name]
    got = chunked(*args, chunk, split3)
    assert share_of_tol(got, ref) <= 0.1


def test_one_tf32_pass_shows_ten_times_the_error(cases):
    args, chunk, ref = cases["n128"]
    scheme = share_of_tol(chunked(*args, chunk, split3), ref)
    single = share_of_tol(chunked(*args, chunk, tf32_once), ref)
    assert single >= 10 * scheme, (single, scheme)
