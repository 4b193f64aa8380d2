"""Traffic kind ``train``: the synthetic training loop.

``make_train_step(task)`` step after step, each drawing its batch from a
generator seeded by ``derive_seed(seed, 2, step)``, with no
synchronisation inside the window. Set-up runs the first
``checked_steps`` steps through the same call on one state; the window
goes on from there with that state. Once the window has closed, the
optimizer's state is copied and ``late_steps`` more steps run through the
same call (outside the window's time and work). A traced run profiles the
steps ``trace_steps`` [from, to) of the window and, outside the profiler,
reads the step's own phase events on ``phase_steps``.

The check, against the reference on the same images: the checked steps
from the seed's weights, and the late steps from the program's own state
after the window (weights and Adam's moments and count; the reference can
only follow the program from there). The set-up steps: every step's loss
(``loss_gap``); the first step's clipped gradient as Adam got it, worked
out from its first moment, and the weights' change over the steps, both
by their worst leaf's gap of norms (``grad_gap``, ``change_gap``); and
that gradient's relative error as a whole (``grad_err``), which a gap of
norms sees only to second order. The late steps: the weights' change
over them as a whole, its relative error (``late_change_err``), which a
state left unchanged reads as 1. Past the warmup the bf16 unroll moves the
L1 loss's gradient by up to a tenth against the float32 reference, as far
as the control does: the late losses and gradients, and a worst leaf's
gap, do not separate the two and are not compared.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench import phantoms as ph
from portbench.loops import DATA_STREAM, TracedSlice, sync
from portbench.reference.precision import CONTROL

__all__ = ["loop", "compare", "controls", "step_images"]

#: the numbers compared, of the set-up steps and of the late steps
START = ("loss_gap", "grad_gap", "change_gap", "grad_err")
LATE = ("change_err",)


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _moments(state) -> tuple:
    """(first moments, second moments, updates made) of the program's Adam."""
    st = state.optimizer.state
    zero = torch.zeros_like
    named = list(state.model.named_parameters())
    return ({k: st[p]["exp_avg"].detach().clone() if p in st else zero(p) for k, p in named},
            {k: st[p]["exp_avg_sq"].detach().clone() if p in st else zero(p) for k, p in named},
            state.step)


def _steps(state, step, gen, first: int, n: int) -> dict:
    """``n`` steps from step ``first`` through the program's call: their
    losses, the first one's clipped gradient from Adam's first moment
    (m₁ = 0.9·m₀ + 0.1·g), the weights before and after."""
    m0, _, _ = _moments(state)
    out = {"p0": _params(state.model), "loss": []}
    for i in range(first, first + n):
        out["loss"].append(float(step(state, gen(i))["loss"]))
        if i == first:
            m1, _, _ = _moments(state)
            out["grad1"] = {k: (m1[k] - 0.9 * m0[k]) / 0.1 for k in m1}
    out["params"] = _params(state.model)
    return out


def loop(run, task, seed: int, seconds: float, trace: bool) -> dict:
    from pdunet_tpu_torch.training.loop import build_state, make_train_step, split_ms

    traffic, device = run.traffic, run.device
    state = build_state(task)
    step = make_train_step(task)

    def gen(i):
        return ph.generator(device, ph.derive_seed(seed, DATA_STREAM, i))

    checked = traffic["checked_steps"]
    start = dict(_steps(state, step, gen, 0, checked), first=0)
    sync(device)
    t_lo, t_hi = traffic["trace_steps"]
    p_lo, p_hi = traffic["phase_steps"]
    run.setup_end()
    i, marks_all = checked, []
    t0 = time.perf_counter()
    untraced_time, untraced_steps, seg_start, traced = 0.0, 0, t0, None
    while True:
        n = i - checked
        if trace and n == t_lo:
            sync(device)
            untraced_time += time.perf_counter() - seg_start
            untraced_steps += n
            traced = TracedSlice(device)
            traced.start()
        marks = [] if trace and p_lo <= n < p_hi else None
        step(state, gen(i), marks)
        if marks is not None:
            marks_all.append(marks)
        i += 1
        n = i - checked
        if traced is not None and n == t_hi:
            run.trace = traced.stop()
            run.trace_units = (t_hi - t_lo) * traffic["batch"]
            traced = None
            seg_start = time.perf_counter()
        if time.perf_counter() - t0 >= seconds and (not trace or n >= max(t_hi, p_hi)):
            break
    sync(device)
    run.elapsed = time.perf_counter() - t0
    steps = i - checked
    run.units = steps * traffic["batch"]
    run.attempted = steps
    if trace:
        untraced_time += time.perf_counter() - seg_start
        untraced_steps += steps - t_hi
        run.untraced_rate = untraced_steps * traffic["batch"] / untraced_time
        phases = [split_ms(m) for m in marks_all]
        run.phase_ms = {k: sum(p[k] for p in phases) / len(phases) for k in phases[0]}
    run.read_memory()
    adam = _moments(state)
    late = dict(_steps(state, step, gen, i, traffic["late_steps"]), first=i, adam=adam)
    return {"start": start, "late": late}


def step_images(cfg: dict, traffic: dict, seed: int, first: int, n: int, device) -> list:
    """The images of steps ``first`` … ``first + n − 1``, drawn again from
    the steps' seeds."""
    g = cfg["geometry"]
    return [ph.phantoms(ph.generator(device, ph.derive_seed(seed, DATA_STREAM, i)),
                        traffic["batch"], g["image_size"], cfg["train"]["n_ellipses"],
                        g["pixel_spacing"], device=device)
            for i in range(first, first + n)]


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def _leaf_gap(got: dict, want: dict, keys) -> float:
    g, w = _norms({k: got[k] for k in keys}), _norms({k: want[k] for k in keys})
    med = statistics.median(w.values())
    return max(abs(g[k] - w[k]) / max(w[k], med) for k in keys)


def _rel_err(got: dict, want: dict, keys) -> float:
    """‖got − want‖ / ‖want‖ over the leaves ``keys`` together."""
    num = sum(float((got[k].double() - want[k].double()).pow(2).sum()) for k in keys)
    return math.sqrt(num / sum(float(want[k].double().pow(2).sum()) for k in keys))


def _gaps(got: dict, want: dict, p0: dict, names) -> dict:
    """``got``'s numbers ``names`` against the reference's ``want``, both
    from ``p0``. Leaves whose reference gradient is under a thousandth of
    the median leaf's leave the change (they move by round-off alone)."""
    keys = list(want["grad1"])
    gref = _norms(want["grad1"])
    med = statistics.median(gref.values())
    moving = [k for k in keys if gref[k] >= 1e-3 * med]
    d_got = {k: got["params"][k].float() - p0[k].float() for k in keys}
    d_ref = {k: want["params"][k] - p0[k].float() for k in keys}
    number = {
        "loss_gap": lambda: max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
        "grad_gap": lambda: _leaf_gap(got["grad1"], want["grad1"], keys),
        "change_gap": lambda: _leaf_gap(d_got, d_ref, moving),
        "grad_err": lambda: _rel_err(got["grad1"], want["grad1"], keys),
        "change_err": lambda: _rel_err(d_got, d_ref, moving)}
    return {n: number[n]() for n in names}


def _reference(run, ref, part: dict, prec=None, fault: str = "") -> dict:
    images = step_images(run.cfg, run.traffic, run.seed, part["first"], len(part["loss"]),
                         run.device)
    kw = {} if prec is None else {"prec": prec}
    sigma = ref.sigma() if prec is None else ref.sigma(prec.lo)
    return ref.train(part["p0"], images, sigma, fault=fault, adam=part.get("adam"), **kw)


def _both(run, ref, prog: dict, got) -> dict:
    out = {}
    for prefix, part, names in (("", prog["start"], START), ("late_", prog["late"], LATE)):
        want = _reference(run, ref, part)
        out.update({prefix + k: v for k, v in _gaps(got(part), want, part["p0"], names).items()})
    return out


def compare(run, ref, prog: dict, weights: dict) -> dict:
    return _both(run, ref, prog, lambda part: part)


def controls(run, ref, prog: dict, weights: dict) -> dict:
    """The control (the reference in the program's place one precision
    below the configuration's) and a fault planted in the reference (half
    of each batch left out), from the program's same starting states."""
    return {"control": _both(run, ref, prog, lambda part: _reference(run, ref, part, CONTROL)),
            "half_batch": _both(run, ref, prog,
                                lambda part: _reference(run, ref, part, fault="half_batch"))}
