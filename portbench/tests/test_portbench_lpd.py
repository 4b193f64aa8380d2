"""The Learned Primal-Dual configuration (``lpd_parallel``): its counts
against their closed forms, its PReLU against the program's, its cell's
check in units of bf16 rounding, and its cell on the CPU with the timed
path broken underneath (its sound runs are ``test_portbench_result``'s)."""

import json

import pytest
import torch
import torch.nn.functional as F

from portbench import counting, harness, modules
from portbench.calibrate import readings
from portbench.tests.test_portbench_faults import _break_forward, _run
from portbench.tests.tiny import cell as tiny

CELL = "lpd_parallel.volume"


def _cfg(**model):
    cfg = json.loads((harness.HERE / "configs" / "lpd_parallel.json").read_text())
    cfg["model"].update(model)
    return cfg


@pytest.mark.parametrize("n", [1, 3, 10])
def test_applies_are_counted(n):
    """A f and A† h in each iteration after the synthesis A and the direct
    reconstruction (2 + 2n); in training the vjp of each but the first
    iteration's A f₀, whose input needs no gradient (+ 2n − 1): 22 / 41 at
    the preset's 10. The first A† h needs its vjp: h is the dual net's."""
    got = counting.counts(_cfg(n_iters=n))["applies_per_slice"]
    assert got == {"recon": 2 + 2 * n, "train": 2 + 2 * n + 2 * n - 1}


def test_conv_flops_are_the_closed_form():
    """2·9·(H·W·Σ cin·cout) a net: the dual at the sinogram's 90 × 256,
    the primal at 256²; in training each convolution's weight and input
    gradients again, but the first dual convolution's input gradient, whose
    input [h = 0, A f₀, g] needs none."""
    cfg = _cfg()
    m, g = cfg["model"], cfg["geometry"]
    n, c = m["n_iters"], m["lpd_features"]
    N = g["image_size"]
    angles, bins = counting._sino_shape(cfg)
    assert (angles, bins) == (90, 256)

    def net(cin, cout, pixels):
        widths = (cin, c, c, cout)
        return 2 * 9 * pixels * sum(a * b for a, b in zip(widths, widths[1:]))

    dual = net(m["dual_channels"] + 2, m["dual_channels"], angles * bins)
    primal = net(m["primal_channels"] + 1, m["primal_channels"], N * N)
    first = 2 * 9 * angles * bins * (m["dual_channels"] + 2) * c
    got = counting.counts(cfg)["conv_flops_per_slice"]
    assert got == {"recon": n * (dual + primal), "train": 3 * n * (dual + primal) - first}


@pytest.mark.parametrize("slope", [-0.3, 0.2])
def test_prelu_is_where_and_the_programs(slope):
    """where(x ≥ 0, x, a·x), as ``F.prelu`` with one slope and the
    program's ``PReLU`` (in the input's dtype), at a negative and a
    positive slope; -0.0 and 0 pass through."""
    from pdunet_tpu_torch.models.primal_dual import PReLU

    prelu = modules.reference_model("lpd").prelu
    x = torch.tensor([-2.0, -0.5, -0.0, 0.0, 0.25, 3.0])
    a = torch.tensor(slope)
    want = torch.tensor([v if v >= 0 else slope * v for v in x.tolist()])
    assert torch.equal(prelu(x, a), want)
    assert torch.equal(prelu(x, a), F.prelu(x, a.reshape(1)))
    act = PReLU(device="cpu")
    with torch.no_grad():
        act.negative_slope.fill_(slope)
        for dt in (torch.float32, torch.bfloat16):
            got = act(x.to(dt))
            assert got.dtype == dt
            assert torch.equal(got, prelu(x.to(dt), a.to(dt)))


def test_reference_holds_the_program_in_float32():
    """Four iterations at 32², the unroll in float32: the two agree to
    rounding (about 3e-6 at 64² and ten iterations). A network coupled
    through the wrong memory channel moves the output by 5-12% at full
    width, 3-13 bf16 roundings, which the bf16 cell's check sees on some
    seeds only, and by less than the shared reference test's 1e-2 at two
    iterations; here it fails."""
    from pdunet_tpu_torch.training.tasks import build_task
    from portbench import phantoms as ph
    from portbench.reference.tasks import RefTask

    cfg = _cfg()
    over = dict(tiny(CELL)["config"], **{"model.n_iters": 4})
    config = harness.program_config(cfg, {"batch": 2}, over)
    task = build_task(config, device="cpu")
    ref = RefTask(harness.resolved(cfg, config), "cpu")
    img = ph.phantoms(ph.generator("cpu", 5), 2, config.geometry.image_size, device="cpu")
    with torch.no_grad():
        recon = task.recon_fn(task.model, task.batch_from_images(img))
        P = {k: v.float() for k, v in task.model.state_dict().items()}
        want = ref.recon_volume(P, img, ref.sigma())["recon"]
    assert float((recon - want).norm() / want.norm()) < 1e-4


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_faults(fault, monkeypatch):
    _break_forward(monkeypatch, fault)
    assert _run(CELL)["correct"] is False


def test_scaled_check_parts_bf16_from_its_control():
    """The unroll in bf16, as the configuration states, over four
    iterations at 32²: the recon's error reads about one bf16 rounding of
    the reference, the fp8 control's many, whatever gain the seed's
    weights give (the worst slice of each moves several times over from
    seed to seed)."""
    limit = json.loads((harness.HERE / "limits" / f"{CELL}.json").read_text())["recon_err_scaled"]
    t = tiny(CELL)
    over = dict(t["config"], **{"model.use_bfloat16": True, "model.n_iters": 4})
    rows = readings(CELL, [11, 12, 13], 3, 0.1, "cpu", emit=lambda _: None,
                    config_overrides=over, traffic_overrides=t["traffic"])
    prog = [r["recon_err_scaled"] for r in rows if r["reading"] == "program"]
    ctl = [r["recon_err_scaled"] for r in rows if r["reading"] == "control"]
    assert len(prog) == len(ctl) == 3
    assert max(prog) < limit / 2 < 2 * limit < min(ctl), (prog, ctl)
