"""A run with the timed path broken underneath reads ``correct`` false:
once for each fault a cell can have (one card: no exchange between chips
to leave out). The look for a card is skipped; the rest is a whole run."""

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import SEED, cell as tiny


def _run(cell):
    t = tiny(cell)
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                            config_overrides=t["config"], traffic_overrides=t["traffic"])


def _break_forward(monkeypatch, how):
    from pdunet_tpu_torch.models import primal_dual

    forward = primal_dual.UnrolledPrimalDual.forward

    def broken(self, g, f0):
        if how == "half_batch":  # half of the slices reconstructed, the rest repeated
            h = g.shape[0] // 2
            out = forward(self, g[:h], f0[:h])
            return torch.cat([out, out[: g.shape[0] - h]])
        out = forward(self, g, f0)  # one slice's answer altered where it is made
        return torch.cat([out[:1] * 1.25, out[1:]])

    monkeypatch.setattr(primal_dual.UnrolledPrimalDual, "forward", broken)


@pytest.mark.parametrize("cell", ["pdunet_parallel.volume", "pdunet_radial.volume"])
def test_volume_sound(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["pdunet_parallel.volume", "pdunet_radial.volume"])
def test_volume_faults(cell, fault, monkeypatch):
    _break_forward(monkeypatch, fault)
    assert _run(cell)["correct"] is False


def test_train_sound():
    assert _run("pdunet_parallel.train")["correct"] is True


def test_train_state_unchanged(monkeypatch):
    from pdunet_tpu_torch.training import loop

    def no_update(state):
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        state.step += 1
        return torch.nn.utils.get_total_norm(grads)

    monkeypatch.setattr(loop, "apply_gradients", no_update)
    assert _run("pdunet_parallel.train")["correct"] is False


def test_train_half_batch(monkeypatch):
    from pdunet_tpu_torch.ops import losses
    from pdunet_tpu_torch.training import tasks

    def half_l1(pred, target):
        h = pred.shape[0] // 2
        return losses.l1(pred[:h], target[:h])

    monkeypatch.setitem(tasks.LOSSES, "l1", half_l1)
    assert _run("pdunet_parallel.train")["correct"] is False


def test_train_fault_inside_the_window(monkeypatch):
    """A step that leaves its state unchanged only after the set-up's
    checked steps is caught by the late steps after the window."""
    from pdunet_tpu_torch.training import loop

    apply = loop.apply_gradients

    def late_no_update(state):
        if state.step < 3:
            return apply(state)
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        state.step += 1
        return torch.nn.utils.get_total_norm(grads)

    monkeypatch.setattr(loop, "apply_gradients", late_no_update)
    r = _run("pdunet_parallel.train")
    assert r["correct"] is False
    assert all(c["value"] <= c["limit"] for k, c in r["checks"].items()
               if not k.startswith("late_"))
