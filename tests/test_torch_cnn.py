"""The port's ResNet18 / VGG16 and CIFAR-like data against the JAX package's.

JAX's parameters are carried across (``params_from_jax``); the same numpy
images go through both packages. Tolerances:

  * ``make_multiclass_images``: equal arrays;
  * the parameter layout: equal leaf paths, shapes and strides;
  * logits: 1e-5 of their largest magnitude; gradients: 1e-4 of each
    leaf's largest magnitude (float32 convolutions summed in another
    order), at widths 4 and 8, on an even and an odd input size — an even
    size pins XLA's "SAME" padding of a stride-2 conv, (0, 1), which
    symmetric padding gets wrong (a control below);
  * a short ``stl_nc1`` run through ``simulate.run`` on the same draws
    (``JaxKey``), dense and int8: the first round within 1e-5, the whole
    history within 2e-4 (dense) and 1e-3 (int8) — nonconvex training
    carries float32 summation-order differences further than the convex
    models do (``TOL`` below).

VGG16 pools five times, so its inputs are 32×32 and 33×33: below 32 the
fifth pool has nothing left to pool in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_replay import JaxKey, to_numpy_tree
from repro.configs.base import TrainConfig as JCfg
from repro.core import simulate as JS
from repro.data import make_multiclass_images as j_images
from repro.data.partition import partition_paper as j_partition
from repro.models import cnn as J
from repro_torch.configs.base import TrainConfig
from repro_torch.core import simulate as TS
from repro_torch.data import make_multiclass_images, partition_paper
from repro_torch.models import cnn
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves


# stl_nc1 histories: ResNet18's loss drifts apart by float32 summation
# order as training goes on, more than the convex models' (1e-5 / 1e-4):
# over these 16 steps the last record measured 7.4e-5 apart dense and
# 2.0e-4 int8; the first round stays within 1e-5 (``FIRST_TOL``)
TOL = {"dense": 2e-4, "int8": 1e-3}
FIRST_TOL = 1e-5


def _images(hw, n=3, seed=0):
    x = np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32)
    return x, np.arange(n, dtype=np.int32) * 3 % 10


def _nets(net, width):
    """(jax params, port params carried across, jax apply, port apply)."""
    if net == "resnet18":
        jp, strides = J.init_resnet18(jax.random.key(0), width=width)
        return (jp, params_from_jax(to_numpy_tree(jp)),
                lambda p, x: J.apply_resnet18(p, strides, x),
                lambda p, x: cnn.apply_resnet18(p, strides, x))
    jp = J.init_vgg16(jax.random.key(0), width=width)
    return (jp, params_from_jax(to_numpy_tree(jp)), J.apply_vgg16,
            cnn.apply_vgg16)


@pytest.mark.parametrize("n,hw,seed", [(64, 32, 0), (40, 15, 3)])
def test_make_multiclass_images_equals_jax(n, hw, seed):
    x, y = make_multiclass_images(n=n, hw=hw, seed=seed)
    jx, jy = j_images(n=n, hw=hw, seed=seed)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.dtype == np.float32 and y.dtype == np.int32
    assert x.shape == (n, hw, hw, 3)


@pytest.mark.parametrize("width", [4, 64])
def test_parameter_layout_matches_jax(width):
    jp, jstrides = J.init_resnet18(jax.random.key(0), width=width)
    tp, tstrides = cnn.init_resnet18(0, width=width, device="cpu")
    jv = J.init_vgg16(jax.random.key(0), width=width)
    tv = cnn.init_vgg16(0, width=width, device="cpu")
    assert tstrides == jstrides
    for t, j in ((tp, jp), (tv, jv)):
        jpaths, _ = jax.tree_util.tree_flatten_with_path(j)
        ours, _ = tree_flatten_with_path(t)
        assert [(p, tuple(x.shape)) for p, x in ours] == \
            [(jax.tree_util.keystr(p), x.shape) for p, x in jpaths]
    assert len(tree_leaves(tp)) == 38 and len(tree_leaves(tv)) == 30
    n_params = sum(x.numel() for x in tree_leaves(tp))
    assert n_params == sum(x.size for x in jax.tree.leaves(jp))
    if width == 64:
        assert n_params == 11_168_202   # ResNet18 at full width


@pytest.mark.parametrize("hw", [16, 15])
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("net", ["resnet18", "vgg16"])
def test_logits_and_grads_match_jax(net, width, hw):
    if net == "vgg16":
        hw = {16: 32, 15: 33}[hw]     # five pools need 32 or more
    x, y = _images(hw)
    jp, tp, japply, tapply = _nets(net, width)
    jl = np.asarray(japply(jp, jnp.asarray(x)))
    tl = tapply(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    jg = jax.grad(lambda p: J.cross_entropy(japply(p, jnp.asarray(x)),
                                            jnp.asarray(y)))(jp)
    tg = torch.func.grad(lambda p: cnn.cross_entropy(
        tapply(p, torch.from_numpy(x)), torch.from_numpy(y)))(tp)
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-12)


def test_same_padding_of_stride_two_is_asymmetric_at_even_sizes():
    assert cnn._same_pad(16, 3, 2) == (0, 1)
    assert cnn._same_pad(15, 3, 2) == (1, 1)
    assert cnn._same_pad(16, 1, 2) == (0, 0)
    assert cnn._same_pad(16, 3, 1) == (1, 1)
    # the control: symmetric padding at 16×16 gives the same shape but
    # other values than XLA's "SAME"
    x = np.random.RandomState(1).randn(2, 16, 16, 4).astype(np.float32)
    w = np.random.RandomState(2).randn(3, 3, 4, 8).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    ours = cnn._conv(xt, torch.from_numpy(w), 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
    sym = torch.nn.functional.conv2d(
        xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
    assert sym.shape == xt.new_empty(2, 8, 8, 8).shape
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - ref).max() > 1e-1


def test_cross_entropy_matches_jax():
    logits = np.random.RandomState(5).randn(6, 10).astype(np.float32) * 3
    labels = np.array([0, 9, 3, 3, 7, 1], np.int32)
    ref = float(J.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    ours = float(cnn.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    assert ours == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("reducer", ["dense", "int8"])
@pytest.mark.parametrize("net", ["resnet18", "vgg16"])
def test_stl_nc1_run_matches_jax(net, reducer):
    """Table 2's protocol at a small size: stl_nc1 (prox), momentum 0.9,
    dense or int8 rounds, Non-IID label-sorted clients."""
    hw = 16 if net == "resnet18" else 32
    x, y = make_multiclass_images(n=64, hw=hw, seed=0)
    data = partition_paper(x, y, 4, iid_percent=0.0, seed=1)
    jdata = j_partition(x, y, 4, iid_percent=0.0, seed=1)
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k])
    jp, tp, japply, tapply = _nets(net, 4)
    cfg = dict(algo="stl_nc1", eta1=0.005, T1=8, k1=4.0, n_stages=2,
               gamma_inv=0.01, iid=False, batch_per_client=4, momentum=0.9,
               reducer=reducer, seed=0)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jhist = JS.run(lambda p, b: J.cross_entropy(japply(p, b["x"]), b["y"]),
                   jp, {k: jnp.asarray(v) for k, v in data.items()},
                   JCfg(**cfg),
                   jax.jit(lambda p: J.cross_entropy(japply(p, xj), yj)),
                   chunk_rounds=2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    thist = TS.run(lambda p, b: cnn.cross_entropy(tapply(p, b["x"]), b["y"]),
                   tp, {k: torch.from_numpy(v) for k, v in data.items()},
                   TrainConfig(**cfg),
                   lambda p: cnn.cross_entropy(tapply(p, xt), yt),
                   device="cpu", chunk_rounds=2,
                   rng=JaxKey(jax.random.key(0)))
    assert [(r.round, r.iteration) for r in thist] == \
        [(r.round, r.iteration) for r in jhist]
    tv, jv = [r.value for r in thist], [r.value for r in jhist]
    np.testing.assert_allclose(tv[:2], jv[:2], atol=FIRST_TOL, rtol=0)
    np.testing.assert_allclose(tv, jv, atol=TOL[reducer], rtol=0)
    assert all(np.isfinite(v) for v in tv) and tv[-1] < tv[0]
