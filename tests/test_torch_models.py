"""The port's networks (pdunet_tpu_torch/models) against flax, with the flax
parameters carried across by models/convert.py.

float32: 1e-4 relative (convolution algorithms may sum in other orders).
bfloat16: 5e-3 relative, about one bf16 ulp (2⁻⁸). The UNets themselves
agree bit for bit in bf16 on the CPU; the PD-UNet's remaining difference
(~7e-4 measured) comes from the projector, which rounds its bf16 operands in
the pair operator in the port and in the per-angle operator in JAX's CPU
path (the projector's own bf16 tolerance is 5e-3).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.models.primal_dual import make_pdunet as jax_make_pdunet
from pdunet_tpu.models.unet import UNet as JaxUNet
from pdunet_tpu.models.unet import depth_to_space as jax_d2s
from pdunet_tpu.models.unet import space_to_depth as jax_s2d
from pdunet_tpu.ops.radon.parallel import make_parallel_ops as jax_ops
from pdunet_tpu_torch.geometry import ParallelGeometry
from pdunet_tpu_torch.models.convert import flax_to_torch, load_flax_unet
from pdunet_tpu_torch.models import primal_dual
from pdunet_tpu_torch.models.primal_dual import ConvNet, make_pdunet
from pdunet_tpu_torch.models.unet import (Conv, ConvTranspose, UNet, _conv, depth_to_space,
                                          space_to_depth)
from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

torch.set_num_threads(1)

_DT = [(False, 1e-4), (True, 5e-3)]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_space_to_depth_matches_flax_order():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    s2d = space_to_depth(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(jax_s2d(jnp.asarray(x), 2)))
    back = depth_to_space(s2d, 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_d2s(jax_s2d(jnp.asarray(x), 2), 2)))


@pytest.mark.parametrize("stem,depth", [(1, 2), (2, 2), (2, 1)])
@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_unet_forward_matches_flax(stem, depth, bf16, tol):
    """Odd spatial sizes exercise the pad-to-multiple and the crop."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jm = JaxUNet(out_channels=2, base_features=8, depth=depth, stem=stem, dtype=jdt)
    x = np.random.default_rng(1).standard_normal((2, 22, 37, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = UNet(in_channels=3, out_channels=2, base_features=8, depth=depth,
              stem=stem, dtype=tdt, device="cpu")
    load_flax_unet(tm, _np_tree(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol


def test_unet_init_is_lecun_normal_with_zero_bias():
    gen = torch.Generator().manual_seed(0)
    m = UNet(in_channels=4, out_channels=1, base_features=32, depth=1, stem=1,
             generator=gen, device="cpu")
    w = m.blocks[1].convs[0].weight  # (64, 32, 3, 3): fan_in 288
    assert abs(w.std().item() * np.sqrt(288) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / np.sqrt(288) / 0.8796 + 1e-6
    assert all(float(b.detach().abs().max()) == 0.0 for n, b in m.named_parameters()
               if n.endswith("bias"))
    # a seed gives the same weights again
    m2 = UNet(in_channels=4, out_channels=1, base_features=32, depth=1, stem=1,
              generator=torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_convert_rejects_mismatched_trees():
    jm = JaxUNet(out_channels=1, base_features=8, depth=2, stem=1)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 2)))["params"]
    with pytest.raises(ValueError):
        load_flax_unet(UNet(in_channels=2, base_features=8, depth=1, device="cpu"),
                       _np_tree(params))
    with pytest.raises(ValueError, match="shape"):
        load_flax_unet(UNet(in_channels=3, base_features=8, depth=2, device="cpu"),
                       _np_tree(params))


@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_pdunet_forward_matches_flax(bf16, tol):
    """Full unroll (2 iterations, base 8, depth 2, stem 2) with both
    packages' own projectors at 32² / 24 angles and converted weights."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    kw = dict(image_size=32, n_angles=24, det_count=32)
    jo = jax_ops(JaxGeometry(**kw), dtype=jdt)
    to = make_parallel_ops(ParallelGeometry(**kw), dtype=tdt, device="cpu")
    sigma = 7.5
    jm = jax_make_pdunet(lambda f: jo.A(f) / sigma, lambda p: jo.At(p) / sigma,
                         n_iters=2, base_features=8, depth=2, stem=2, dtype=jdt)
    tm = make_pdunet(lambda f: to.A(f) / sigma, lambda p: to.At(p) / sigma,
                     n_iters=2, base_features=8, depth=2, stem=2, dtype=tdt,
                     device="cpu")
    rng = np.random.default_rng(2)
    g = rng.standard_normal((2, 24, 32)).astype(np.float32)
    f0 = rng.standard_normal((2, 32, 32)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(g), jnp.asarray(f0))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(g), jnp.asarray(f0)))
    flax_to_torch(_np_tree(params), tm)
    with torch.no_grad():
        out = tm(torch.from_numpy(g), torch.from_numpy(f0))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert rel(out, ref) < tol


def test_pdunet_is_differentiable_through_the_operators():
    to = make_parallel_ops(ParallelGeometry(image_size=16, n_angles=12), device="cpu")
    tm = make_pdunet(to.A, to.At, n_iters=1, base_features=4, depth=1, stem=1,
                     generator=torch.Generator().manual_seed(3), device="cpu")
    f0 = torch.randn(1, 16, 16, requires_grad=True)
    g = torch.randn(1, 12, 16)
    tm(g, f0).square().sum().backward()
    assert f0.grad is not None and torch.isfinite(f0.grad).all()
    assert all(p.grad is not None for p in tm.parameters())


# -- the UNet's layout: channels_last inside, NCHW at its boundary ----------------

def _s2d_nchw(x, s):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h // s, w // s)


def _d2s_nchw(x, s):
    b, c, h, w = x.shape
    x = x.reshape(b, s, s, c // (s * s), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (s * s), h * s, w * s)


def _nchw_forward(m, x):
    """``UNet.forward`` as it ran before its layers went channels_last: pad,
    cast, space-to-depth, then the same modules on contiguous NCHW tensors."""
    h, w = x.shape[-2:]
    mult = m.stem << m.depth
    x = F.pad(x, (0, (-w) % mult, 0, (-h) % mult)).to(m.dtype)
    if m.stem > 1:
        x = _s2d_nchw(x, m.stem)
    skips = []
    for d in range(m.depth):
        x = m.blocks[d](x)
        skips.append(x)
        x = F.max_pool2d(x, 2, 2)
    x = m.blocks[m.depth](x)
    for i, d in enumerate(reversed(range(m.depth))):
        x = m.ups[i](x)
        if m.upsample == "shuffle":
            x = _d2s_nchw(x, 2)
        x = m.blocks[m.depth + 1 + i](torch.cat([x, skips[d]], dim=1))
    x = m.head(x)
    if m.stem > 1:
        x = _d2s_nchw(x, m.stem)
    return x.float()[..., :h, :w]


def _channels_last(t):
    """Channels_last and not also NCHW-contiguous (no dim of size 1 makes
    the two layouts one)."""
    return t.is_contiguous(memory_format=torch.channels_last) and not t.is_contiguous()


def _nchw(t):
    return t.is_contiguous() and not t.is_contiguous(memory_format=torch.channels_last)


def _record_convs(model):
    """Forward hooks on every Conv / ConvTranspose of ``model``: a list that
    fills with (input, output) per call, and the hooks' handles."""
    seen = []
    handles = [mod.register_forward_hook(lambda mod, args, out: seen.append((args[0], out)))
               for mod in model.modules() if isinstance(mod, (Conv, ConvTranspose))]
    return seen, handles


@pytest.mark.parametrize("stem,depth,upsample", [(1, 2, "convtranspose"), (2, 2, "convtranspose"),
                                                 (2, 1, "shuffle"), (1, 3, "shuffle")])
@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_unet_layers_run_channels_last(stem, depth, upsample, bf16, tol):
    """Every convolution of the UNet takes and gives channels_last tensors in
    the compute dtype (so cuDNN's NHWC kernels need no conversion), while the
    UNet takes and returns NCHW float32 as before: the same shape, dtype,
    contiguity and values as the NCHW forward of the same modules, whose
    convolutions stay NCHW."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    m = UNet(in_channels=3, out_channels=2, base_features=4, depth=depth, stem=stem,
             dtype=dtype, upsample=upsample, generator=torch.Generator().manual_seed(4),
             device="cpu")
    for p in m.parameters():  # biases away from their zero init, so a wrong one shows
        if p.dim() == 1:
            p.data.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(p.numel()))
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(5))
    seen, handles = _record_convs(m)
    with torch.no_grad():
        out = m(x)
        n_convs = len(seen)
        ref = _nchw_forward(m, x)
    for h in handles:
        h.remove()
    assert n_convs == 2 * (2 * depth + 1) + depth + 1
    for t_in, t_out in seen[:n_convs]:
        assert _channels_last(t_in) and _channels_last(t_out)
        assert t_in.dtype == t_out.dtype == dtype
    assert all(_nchw(t_in) and _nchw(t_out) for t_in, t_out in seen[n_convs:])
    assert out.shape == ref.shape == (3, 2, 32, 32)
    assert out.dtype == ref.dtype == torch.float32
    assert out.is_contiguous() and ref.is_contiguous()
    assert rel(out, ref) < tol


class _ActivationCopies(TorchDispatchMode):
    """The copies (``copy_``, ``clone``, ``_to_copy``, padding) of tensors
    whose leading dim is ``batch`` (activations, not weights) that ``model``
    makes outside its Conv / ConvTranspose calls (on the CPU those compute
    in NCHW and convert inside; on the card they convert nothing)."""

    OPS = ("aten.copy_", "aten.clone", "aten._to_copy", "aten.constant_pad_nd")

    def __init__(self, model, batch):
        super().__init__()
        self.batch, self.ops, self.depth = batch, [], 0
        self.handles = []
        for mod in model.modules():
            if isinstance(mod, (Conv, ConvTranspose)):
                self.handles += [mod.register_forward_pre_hook(lambda *a: self._step(1)),
                                 mod.register_forward_hook(lambda *a: self._step(-1))]

    def _step(self, d):
        self.depth += d

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        t = args[0] if args else None
        if name in self.OPS and not self.depth and isinstance(t, torch.Tensor) \
                and t.dim() >= 4 and t.shape[0] == self.batch:
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("size,entry", [((32, 32), 1), ((22, 37), 2)], ids=["fits", "padded"])
@pytest.mark.parametrize("upsample", ["convtranspose", "shuffle"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_unet_copies_activations_only_at_its_ends(size, entry, upsample, bf16):
    """Per UNet the layout work left is the entry (pad, cast and
    space-to-depth in one copy, two when the input needs padding) and the
    exit (depth-to-space, float32 and crop in one copy), plus the shuffle
    upsample's own depth-to-space, one copy a level: no pooling,
    concatenation or cast between the layers copies an activation."""
    depth = 2
    m = UNet(in_channels=3, out_channels=2, base_features=4, depth=depth, stem=2,
             dtype=torch.bfloat16 if bf16 else torch.float32, upsample=upsample,
             device="cpu")
    x = torch.randn(3, 3, *size)
    copies = _ActivationCopies(m, batch=3)
    with torch.no_grad(), copies:
        m(x)
    for h in copies.handles:
        h.remove()
    shuffles = depth if upsample == "shuffle" else 0
    assert len(copies.ops) == entry + shuffles + 1, copies.ops


@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_unet_loads_an_nchw_state_dict(bf16, tol):
    """A state_dict saved by the NCHW UNet (contiguous tensors, lecun-drawn
    from a seed as it drew them, biases set) loads into the channels_last
    UNet: keys, shapes and values as saved, and the output of the NCHW
    forward. A state_dict the new UNet saves has the same keys, shapes and
    values."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    kw = dict(in_channels=3, out_channels=2, base_features=8, depth=2, stem=2, dtype=dtype,
              device="cpu")
    gen = torch.Generator().manual_seed(6)
    saved = {k: (v.contiguous() if v.dim() > 1 else torch.randn(v.shape, generator=gen) * 0.1)
             for k, v in UNet(generator=torch.Generator().manual_seed(7), **kw)
             .state_dict().items()}
    assert all(v.is_contiguous() for v in saved.values())
    buf = io.BytesIO()
    torch.save(saved, buf)
    buf.seek(0)
    m = UNet(generator=torch.Generator().manual_seed(8), **kw)
    m.load_state_dict(torch.load(buf, weights_only=True))
    assert all(_channels_last(p) for p in m.parameters() if p.dim() == 4
               and p.shape[-1] > 1)
    state = m.state_dict()
    assert list(state) == list(saved)
    for k, v in saved.items():
        assert state[k].shape == v.shape and torch.equal(state[k], v)
    x = torch.randn(2, 3, 32, 32, generator=gen)
    with torch.no_grad():
        out = m(x)
        ref = _nchw_forward(m, x)
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.float32
    assert rel(out, ref) < tol


# -- LPD's ConvNet: channels_last inside, channels zero-padded on the card ---------

def _record_convnet_convs(monkeypatch):
    """Every ``_conv`` call of ``models/primal_dual.py``: a list that fills
    with (input, weight, bias, output) per call; the weight and bias keep
    their gradients."""
    seen = []

    def record(op, x, w, b, dtype, **kw):
        if w.requires_grad:
            w.retain_grad()
            b.retain_grad()
        out = _conv(op, x, w, b, dtype, **kw)
        seen.append((x, w, b, out))
        return out

    monkeypatch.setattr(primal_dual, "_conv", record)
    return seen


def test_convnet_pads_only_on_the_card():
    assert primal_dual._channel_multiple(torch.device("cuda")) == 8
    assert primal_dual._channel_multiple(torch.device("cpu")) == 1


@pytest.mark.parametrize("multiple", [1, 8], ids=["cpu", "card"])
def test_convnet_runs_channels_last(monkeypatch, multiple):
    """Every convolution of LPD's ConvNet takes and gives channels_last
    tensors in the compute dtype, their channels padded to the device's
    multiple (the card's 8 forced here on the CPU) with zero weight and bias
    slices; the ConvNet takes and returns NCHW float32 with the unpadded
    channels; its parameters keep their shapes, layout and state-dict keys."""
    monkeypatch.setattr(primal_dual, "_channel_multiple", lambda device: multiple)
    net = ConvNet(7, 5, features=32, dtype=torch.bfloat16, device="cpu")
    seen = _record_convnet_convs(monkeypatch)
    with torch.no_grad():
        out = net(torch.randn(2, 7, 19, 26))
    assert len(seen) == 3
    up = primal_dual._round_up
    for (x, w, b, y), (cin, cout) in zip(seen, [(7, 32), (32, 32), (32, 5)]):
        assert _channels_last(x) and _channels_last(y)
        assert x.dtype == y.dtype == torch.bfloat16
        assert x.shape[1] == w.shape[1] == up(cin, multiple)
        assert y.shape[1] == w.shape[0] == b.shape[0] == up(cout, multiple)
        assert not w[cout:].any() and not w[:, cin:].any() and not b[cout:].any()
    assert _nchw(out) and out.dtype == torch.float32 and out.shape == (2, 5, 19, 26)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        "convs.0.weight": (32, 7, 3, 3), "convs.0.bias": (32,),
        "convs.1.weight": (32, 32, 3, 3), "convs.1.bias": (32,),
        "convs.2.weight": (5, 32, 3, 3), "convs.2.bias": (5,),
        "acts.0.negative_slope": (), "acts.1.negative_slope": ()}
    assert all(p.is_contiguous() for p in net.parameters())


def _plain_convnet(net, x):
    """The ConvNet as plain NCHW ``F.conv2d`` + PReLU on its parameters."""
    for conv, act in zip(net.convs, net.acts):
        x = F.conv2d(x, conv.weight, conv.bias, padding=1)
        x = torch.where(x >= 0, x, act.negative_slope * x)
    return F.conv2d(x, net.convs[-1].weight, net.convs[-1].bias, padding=1)


@pytest.mark.parametrize("cin,cout", [(7, 5), (6, 5), (14, 10), (8, 8)])
def test_convnet_padding_is_exact(monkeypatch, cin, cout):
    """In float64, with the card's padding forced on the CPU, the ConvNet
    (its residual form, as the unroll calls it) matches the plain NCHW
    composition to 1e-12, and so do the gradients of its input, weights,
    biases and slopes; the padded weights' and biases' gradients are exactly
    zero in their pad slices; the output without a residual is the same
    values in float32."""
    monkeypatch.setattr(primal_dual, "_channel_multiple", lambda device: 8)
    net = ConvNet(cin, cout, features=32, dtype=torch.float64,
                  generator=torch.Generator().manual_seed(cin), device="cpu").double()
    gen = torch.Generator().manual_seed(10 + cout)
    with torch.no_grad():
        for p in net.parameters():  # biases and slopes away from their init
            if p.dim() < 4:
                p.uniform_(-0.3, 0.3, generator=gen)
    x = torch.randn(2, cin, 11, 13, dtype=torch.float64, generator=gen)
    r = torch.randn(2, cout, 11, 13, dtype=torch.float64, generator=gen)
    probe = torch.randn(2, cout, 11, 13, dtype=torch.float64, generator=gen)

    def grads(fn):
        xg = x.clone().requires_grad_()
        net.zero_grad()
        out = fn(xg)
        (out * probe).sum().backward()
        return out.detach(), [xg.grad] + [p.grad.clone() for p in net.parameters()]

    want, want_g = grads(lambda xg: r + _plain_convnet(net, xg))
    seen = _record_convnet_convs(monkeypatch)
    got, got_g = grads(lambda xg: net(xg, residual=r))
    assert got.dtype == torch.float64 and _nchw(got)
    assert rel(got, want) <= 1e-12
    for g, w in zip(got_g, want_g):
        assert g.shape == w.shape and rel(g, w) <= 1e-12
    padded, up = 0, primal_dual._round_up
    for (_, w, b, _), conv in zip(seen, net.convs):
        o, i = conv.weight.shape[:2]
        assert w.shape[:2] == w.grad.shape[:2] == (up(o, 8), up(i, 8))
        assert torch.equal(w.grad[:o, :i], conv.weight.grad)
        assert torch.equal(b.grad[:o], conv.bias.grad)
        assert not w.grad[o:].any() and not w.grad[:, i:].any() and not b.grad[o:].any()
        padded += w.shape[:2] != (o, i)
    assert padded == (cin % 8 > 0) + (cout % 8 > 0)
    with torch.no_grad():
        assert torch.equal(net(x), net(x, residual=torch.zeros_like(r)).float())


def test_convnet_counts_only_card_calls():
    """The counters ``convnet.channels_last`` and ``convnet.padded_convs``
    are registered with the trace module and count no CPU call."""
    from pdunet_tpu_torch.utils import trace

    before = {k: trace._COUNTERS[k]() for k in ("convnet.channels_last", "convnet.padded_convs")}
    with torch.no_grad():
        ConvNet(7, 5, features=8, device="cpu")(torch.randn(1, 7, 8, 8))
    assert {k: trace._COUNTERS[k]() for k in before} == before
