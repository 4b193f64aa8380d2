"""The plain reference against the program at a tiny size on the CPU, and
the reference operators' adjoint identities."""

import json

import pytest
import torch

from portbench import harness
from portbench import phantoms as ph
from portbench.reference.precision import CONTROL, round_fp8, round_fp8_grad, round_tf32
from portbench.reference.radial import RadialRef
from portbench.reference.radon import ParallelRef, sparse_angles
from portbench.reference.tasks import RefTask
from portbench.tests.tiny import CONFIGS, config_overrides


def _rel(a, r):
    return float((a - r).abs().norm() / r.abs().norm())


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_program(name, bf16):
    """The configuration at its cells' tiny sizes, its unroll in bfloat16
    and in float32."""
    from pdunet_tpu_torch.training.tasks import build_task

    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    config = harness.program_config(cfg, {"batch": 2},
                                    dict(config_overrides(name), **{"model.use_bfloat16": bf16}))
    task = build_task(config, device="cpu")
    cfg = harness.resolved(cfg, config)
    ref = RefTask(cfg, "cpu")
    gen = ph.generator("cpu", 5)
    img = (ph.complex_phantoms if ref.complex else ph.phantoms)(
        gen, 2, config.geometry.image_size, device="cpu")
    with torch.no_grad():
        batch = task.batch_from_images(img)
        recon = task.recon_fn(task.model, batch)
    sino, f0 = ref.synth(img)
    assert _rel(batch["sino"], sino) < 1e-5 and _rel(batch["f0"], f0) < 1e-5
    assert abs(ref.sigma() / task.sigma - 1) < 1e-2
    P = {k: v.float() for k, v in task.model.state_dict().items()}
    with torch.no_grad():
        out = ref.unroll(P, sino, f0, ref.sigma())
    assert _rel(recon, out.abs() if ref.complex else out) < 1e-2


def test_operators_are_adjoint():
    gen = torch.Generator().manual_seed(1)
    par = ParallelRef(16, sparse_angles(24, 3), "cpu")
    x = torch.randn(2, 16, 16, generator=gen, dtype=torch.float32)
    y = torch.randn(2, par.A, par.S, generator=gen)
    assert abs(float((par.A_(x) * y).sum() - (x * par.At_(y)).sum())) < 1e-3 * float(
        (par.A_(x) * y).abs().sum())
    rad = RadialRef(16, 12, 32, "cpu")
    z = torch.complex(torch.randn(2, 16, 16, generator=gen), torch.randn(2, 16, 16, generator=gen))
    k = torch.complex(torch.randn(2, 12, 32, generator=gen), torch.randn(2, 12, 32, generator=gen))
    lhs = (rad.A_(z) * k.conj()).sum()
    rhs = (z * rad.At_(k).conj()).sum()
    assert abs(complex(lhs - rhs)) < 1e-4 * abs(complex(lhs))


def test_control_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 3.0, -7.25, 1e-3])
    assert round_tf32(x)[0] == 1.0 and round_tf32(x)[1] == 3.0
    y = torch.linspace(-3, 3, 101)
    err = (round_fp8(y) - y).abs().max() / 3
    assert 2 ** -6 < err <= 2 ** -4
    z = torch.ones(3, requires_grad=True)
    (CONTROL.lo(z) * torch.tensor([1.0, 1.1, 1.2])).sum().backward()
    assert torch.equal(z.grad, round_fp8_grad(torch.tensor([1.0, 1.1, 1.2])))
    assert not torch.equal(z.grad, torch.tensor([1.0, 1.1, 1.2]))
