"""The networks of the port's slice B against flax, with the flax parameters
carried across by models/convert.py: the shuffle-upsample UNet, flax's
PReLU, the LPD ConvNet, and the full LPD unroll (real and complex
operators, per-iteration and shared weights), plus the converter's tree
shapes and refusals.

float32 1e-4, bfloat16 5e-3 relative (tests/test_torch_models.py's _DT).
Small shapes: 32² with 24 parallel angles (radial: 24 spokes of 64
samples), base 8, depth 1-2, 2 iterations.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.models.primal_dual import ConvNet as JaxConvNet
from pdunet_tpu.models.primal_dual import UnrolledPrimalDual as JaxUPD
from pdunet_tpu.models.primal_dual import make_lpd as jax_make_lpd
from pdunet_tpu.models.primal_dual import make_pdunet as jax_make_pdunet
from pdunet_tpu.models.unet import UNet as JaxUNet
from pdunet_tpu.ops import nufft as jax_nufft
from pdunet_tpu.ops.radon.parallel import make_parallel_ops as jax_ops
from pdunet_tpu_torch.geometry import ParallelGeometry, RadialGeometry
from pdunet_tpu_torch.models.convert import flax_to_torch, load_flax_convnet, load_flax_unet
from pdunet_tpu_torch.models.primal_dual import ConvNet, PReLU, make_lpd, make_pdunet
from pdunet_tpu_torch.models.unet import UNet
from pdunet_tpu_torch.ops.nufft import make_radial_ops
from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

torch.set_num_threads(1)

_DT = [(False, 1e-4), (True, 5e-3)]
_DT_IDS = ["f32", "bf16"]


def rel(a, b):
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _dtypes(bf16):
    return (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# -- the shuffle UNet ------------------------------------------------------------

@pytest.mark.parametrize("stem,depth", [(1, 2), (2, 2), (2, 1)])
@pytest.mark.parametrize("bf16,tol", _DT, ids=_DT_IDS)
def test_shuffle_unet_forward_matches_flax(stem, depth, bf16, tol):
    """upsample="shuffle": a 1x1 conv to 4x the features, then
    depth_to_space in flax's channel order; odd spatial sizes exercise the
    pad and the crop."""
    jdt, tdt = _dtypes(bf16)
    jm = JaxUNet(out_channels=2, base_features=8, depth=depth, stem=stem, dtype=jdt,
                 upsample="shuffle")
    x = np.random.default_rng(1).standard_normal((2, 23, 37, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = UNet(in_channels=3, out_channels=2, base_features=8, depth=depth, stem=stem,
              dtype=tdt, upsample="shuffle", device="cpu")
    # flax numbers the up-convs Conv_0 … Conv_{depth-1} and the head Conv_{depth}
    assert {f"Conv_{i}" for i in range(depth + 1)} <= set(params)
    assert tuple(tm.ups[0].weight.shape[-2:]) == (1, 1)
    load_flax_unet(tm, _np_tree(params))
    with torch.no_grad():
        out = _nhwc(tm(_nchw(x)))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol


def test_shuffle_and_convtranspose_have_the_same_weight_count():
    """The same linear family: equal kernel sizes; the shuffle's bias is
    per sub-pixel (4x), the transposed convolution's per output channel."""
    kw = dict(in_channels=1, base_features=8, depth=2, stem=2, device="cpu")
    nets = [UNet(upsample=u, **kw) for u in ("convtranspose", "shuffle")]
    assert ([up.weight.numel() for up in nets[0].ups]
            == [up.weight.numel() for up in nets[1].ups])
    assert ([4 * up.bias.numel() for up in nets[0].ups]
            == [up.bias.numel() for up in nets[1].ups])


def test_unknown_upsample_raises():
    with pytest.raises(ValueError, match="upsample"):
        UNet(in_channels=1, base_features=8, depth=1, upsample="bilinear", device="cpu")


def test_shuffle_pdunet_matches_flax():
    """make_pdunet passes upsample to both UNets (flax's make_pdunet too)."""
    kw = dict(image_size=32, n_angles=24, det_count=32)
    jo = jax_ops(JaxGeometry(**kw))
    to = make_parallel_ops(ParallelGeometry(**kw), device="cpu")
    sigma = 7.5
    mk = dict(n_iters=2, base_features=8, depth=2, stem=2, upsample="shuffle")
    jm = jax_make_pdunet(lambda f: jo.A(f) / sigma, lambda p: jo.At(p) / sigma, **mk)
    tm = make_pdunet(lambda f: to.A(f) / sigma, lambda p: to.At(p) / sigma, device="cpu", **mk)
    g, f0 = _real_inputs(3)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(g), jnp.asarray(f0))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(g), jnp.asarray(f0)))
    flax_to_torch(_np_tree(params), tm)
    with torch.no_grad():
        out = tm(torch.from_numpy(g), torch.from_numpy(f0))
    assert rel(out, ref) < 1e-4


# -- PReLU and the LPD ConvNet ---------------------------------------------------

def test_prelu_is_flax_prelu():
    """A scalar slope starting at 0.01 (torch.nn.PReLU: 0.25), applied in
    the input's dtype."""
    act = PReLU(device="cpu")
    assert act.negative_slope.shape == () and act.negative_slope.item() == pytest.approx(0.01)
    assert act.negative_slope.dtype == torch.float32
    x = torch.tensor([-2.0, -0.5, 0.0, 3.0])
    torch.testing.assert_close(act(x), torch.tensor([-0.02, -0.005, 0.0, 3.0]))
    xb = x.to(torch.bfloat16)
    assert act(xb).dtype == torch.bfloat16
    torch.testing.assert_close(act(xb), torch.where(xb >= 0, xb, torch.tensor(
        0.01, dtype=torch.bfloat16) * xb), rtol=0, atol=0)


@pytest.mark.parametrize("bf16,tol", _DT, ids=_DT_IDS)
def test_convnet_matches_flax(bf16, tol):
    jdt, tdt = _dtypes(bf16)
    jm = JaxConvNet(out_channels=5, features=32, dtype=jdt)
    x = np.random.default_rng(2).standard_normal((2, 19, 26, 7)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    # slopes away from their init, so a wrong slope shows
    params = dict(params, PReLU_0={"negative_slope": jnp.float32(0.3)},
                  PReLU_1={"negative_slope": jnp.float32(-0.2)})
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = ConvNet(7, 5, features=32, dtype=tdt, device="cpu")
    load_flax_convnet(tm, _np_tree(params))
    with torch.no_grad():
        out = _nhwc(tm(_nchw(x)))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol


def test_convnet_init_is_flax_init():
    gen = torch.Generator().manual_seed(0)
    net = ConvNet(7, 5, features=32, generator=gen, device="cpu")
    assert [tuple(c.weight.shape) for c in net.convs] == [(32, 7, 3, 3), (32, 32, 3, 3),
                                                          (5, 32, 3, 3)]
    assert all(a.negative_slope.item() == pytest.approx(0.01) for a in net.acts)
    assert all(float(c.bias.abs().max()) == 0.0 for c in net.convs)
    w = net.convs[1].weight
    assert abs(w.std().item() * np.sqrt(288) - 1.0) < 0.1


# -- the LPD unroll --------------------------------------------------------------

def _real_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 24, 32)).astype(np.float32),
            rng.standard_normal((2, 32, 32)).astype(np.float32))


def _complex_inputs(seed):
    rng = np.random.default_rng(seed)

    def c(shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    return c((2, 24, 64)), c((2, 32, 32))


def _lpd_pair(complex_ops, share_weights, jdt, tdt, n_iters=2):
    """(flax model, port model, inputs) with each package's own operators
    (parallel 32² / 24 angles, or radial 24 spokes of 64 samples)."""
    if complex_ops:
        jo = jax_nufft.make_radial_ops(JaxRadial(image_size=32, n_spokes=24), dtype=jdt)
        to = make_radial_ops(RadialGeometry(image_size=32, n_spokes=24), dtype=tdt,
                             device="cpu")
        sigma, inputs = 60.0, _complex_inputs(4)
    else:
        kw = dict(image_size=32, n_angles=24, det_count=32)
        jo = jax_ops(JaxGeometry(**kw), dtype=jdt)
        to = make_parallel_ops(ParallelGeometry(**kw), dtype=tdt, device="cpu")
        sigma, inputs = 7.5, _real_inputs(5)
    step = 2 if complex_ops else 1
    # flax's make_lpd has no share_weights: build its UnrolledPrimalDual
    jm = JaxUPD(A=lambda f: jo.A(f) / sigma, At=lambda p: jo.At(p) / sigma,
                make_dual=lambda: JaxConvNet(5 * step, 32, dtype=jdt),
                make_primal=lambda: JaxConvNet(5 * step, 32, dtype=jdt),
                n_iters=n_iters, primal_channels=5, dual_channels=5,
                share_weights=share_weights, complex_ops=complex_ops)
    tm = make_lpd(lambda f: to.A(f) / sigma, lambda p: to.At(p) / sigma, n_iters=n_iters,
                  complex_ops=complex_ops, dtype=tdt, share_weights=share_weights,
                  device="cpu")
    return jm, tm, inputs


@pytest.mark.parametrize("share_weights", [False, True], ids=["per_iter", "shared"])
@pytest.mark.parametrize("complex_ops", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("bf16,tol", _DT, ids=_DT_IDS)
def test_lpd_unroll_matches_flax(complex_ops, share_weights, bf16, tol):
    """5-channel memories (f0 tiled, h zeros; complex: [Re, Im, Re, Im, …]),
    the operators on channel 0 (complex 0:2), dual 7 → 5 and primal 6 → 5
    (complex 14 → 10, 12 → 10), per-iteration or shared nets."""
    jdt, tdt = _dtypes(bf16)
    jm, tm, (g, f0) = _lpd_pair(complex_ops, share_weights, jdt, tdt)
    step = 2 if complex_ops else 1
    it = tm.iterations[0]
    assert it.dual.convs[0].weight.shape[1] == 7 * step
    assert it.primal.convs[0].weight.shape[1] == 6 * step
    assert it.dual.convs[-1].weight.shape[0] == it.primal.convs[-1].weight.shape[0] == 5 * step
    assert len(tm.iterations) == (1 if share_weights else 2) and tm.n_iters == 2
    assert tm.share_weights == share_weights
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(g), jnp.asarray(f0))["params"]
    # move every PReLU slope off its init, per iteration where stacked
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (v + 0.1 * jnp.arange(1, v.size + 1).reshape(v.shape)
                         if "negative_slope" in jax.tree_util.keystr(path) else v), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(g), jnp.asarray(f0)))
    flax_to_torch(_np_tree(params), tm)
    with torch.no_grad():
        out = tm(torch.from_numpy(g), torch.from_numpy(f0))
    assert out.shape == ref.shape == (2, 32, 32)
    assert out.dtype == (torch.complex64 if complex_ops else torch.float32)
    assert rel(out, ref) < tol


def test_make_lpd_matches_flax_make_lpd():
    """The task's constructor against flax's make_lpd (per-iteration weights,
    Adler-Öktem widths), with remat on both sides: the remat scan's name
    (ScanCheckpoint_PDIteration_0) loads too, and remat changes nothing."""
    kw = dict(image_size=32, n_angles=24, det_count=32)
    jo = jax_ops(JaxGeometry(**kw))
    to = make_parallel_ops(ParallelGeometry(**kw), device="cpu")
    jm = jax_make_lpd(lambda f: jo.A(f) / 7.5, lambda p: jo.At(p) / 7.5, n_iters=3, remat=True)
    tm = make_lpd(lambda f: to.A(f) / 7.5, lambda p: to.At(p) / 7.5, n_iters=3, remat=True,
                  device="cpu")
    g, f0 = _real_inputs(9)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(g), jnp.asarray(f0))["params"]
    assert list(params) == ["ScanCheckpoint_PDIteration_0"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(g), jnp.asarray(f0)))
    flax_to_torch(_np_tree(params), tm)
    gt = torch.from_numpy(g)
    f0t = torch.from_numpy(f0).requires_grad_(True)
    out = tm(gt, f0t)
    assert rel(out.detach(), ref) < 1e-4
    out.square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tm.parameters())


def test_lpd_is_differentiable_and_shares_gradients():
    """Shared weights: one set of parameters, whose gradient sums over the
    unroll's steps."""
    to = make_parallel_ops(ParallelGeometry(image_size=16, n_angles=12), device="cpu")
    tm = make_lpd(to.A, to.At, n_iters=3, features=8, share_weights=True,
                  generator=torch.Generator().manual_seed(1), device="cpu")
    assert len(list(tm.parameters())) == 2 * (3 + 3 + 2)  # 2 nets: 3 w, 3 b, 2 slopes
    f0 = torch.randn(1, 16, 16)
    tm(torch.randn(1, 12, 16), f0).square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tm.parameters())


# -- the converter ---------------------------------------------------------------

_PDUNET_KEY = re.compile(
    r"iterations\.\d+\.(dual|primal)\.(blocks\.\d+\.convs\.\d+|ups\.\d+|head)\.(weight|bias)")


def test_pdunet_state_dict_keys_are_unchanged():
    """The PD-UNet's memories gained channel counts, not parameters: its
    state_dict keys keep their scheme, so checkpoints written before LPD
    support still load."""
    to = make_parallel_ops(ParallelGeometry(image_size=16, n_angles=12), device="cpu")
    tm = make_pdunet(to.A, to.At, n_iters=2, base_features=4, depth=2, stem=2, device="cpu")
    keys = list(tm.state_dict())
    assert len(keys) == 2 * 2 * (2 * 5 * 2 + 2 * 2 + 2)
    assert all(_PDUNET_KEY.fullmatch(k) for k in keys), keys


@pytest.mark.parametrize("upsample", ["convtranspose", "shuffle"])
def test_convert_loads_bare_unet_trees(upsample):
    """The fbp/sino tasks' model.init has no scan wrapper: flax_to_torch
    takes the bare UNet tree."""
    jm = JaxUNet(out_channels=1, base_features=8, depth=2, stem=2, upsample=upsample)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))["params"]
    tm = UNet(in_channels=1, base_features=8, depth=2, stem=2, upsample=upsample, device="cpu")
    flax_to_torch(_np_tree(params), tm)
    head = params[f"Conv_{2}" if upsample == "shuffle" else "Conv_0"]["kernel"]
    np.testing.assert_array_equal(tm.head.weight.detach().numpy()[:, :, 0, 0],
                                  np.asarray(head)[0, 0].T)


def test_convert_rejects_mismatched_slice_b_trees():
    # a shuffle tree into a convtranspose UNet, and the reverse
    for src, dst in (("shuffle", "convtranspose"), ("convtranspose", "shuffle")):
        jm = JaxUNet(out_channels=1, base_features=8, depth=2, stem=1, upsample=src)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)))["params"]
        with pytest.raises(ValueError):
            load_flax_unet(UNet(in_channels=1, base_features=8, depth=2, upsample=dst,
                                device="cpu"), _np_tree(params))
    # LPD trees: shared into per-iteration, per-iteration into shared, wrong
    # iteration count, and an LPD tree into a PD-UNet
    trees = {}
    for share in (False, True):
        jm, _, (g, f0) = _lpd_pair(False, share, jnp.float32, torch.float32)
        trees[share] = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(g),
                                        jnp.asarray(f0))["params"])
    to = make_parallel_ops(ParallelGeometry(image_size=32, n_angles=24, det_count=32),
                           device="cpu")
    with pytest.raises(ValueError):
        flax_to_torch(trees[True], make_lpd(to.A, to.At, n_iters=2, device="cpu"))
    with pytest.raises(ValueError):
        flax_to_torch(trees[False], make_lpd(to.A, to.At, n_iters=3, device="cpu"))
    with pytest.raises((ValueError, IndexError)):
        flax_to_torch(trees[False], make_lpd(to.A, to.At, n_iters=2, share_weights=True,
                                             device="cpu"))
    with pytest.raises(ValueError):
        flax_to_torch(trees[False], make_pdunet(to.A, to.At, n_iters=2, base_features=8,
                                                depth=1, device="cpu"))
    # a UNet tree into an unroll, and an unroll tree into a UNet
    unet = UNet(in_channels=1, base_features=8, depth=1, device="cpu")
    with pytest.raises(ValueError):
        flax_to_torch(trees[False], unet)
    with pytest.raises(ValueError):
        flax_to_torch({"ConvBlock_0": {}}, make_lpd(to.A, to.At, n_iters=2, device="cpu"))
