"""Traffic kind ``volume``: one client reconstructs volume after volume, a
closed loop.

A request is the program's serving path for a batch of slices:
``task.batch_from_images(images)`` (float32 synthesis and direct recon),
``task.recon_fn(task.model, batch)`` (the unroll), and the reconstructed
volume copied to pinned host memory; its latency runs from the call to the
end of the copy. Images cycle through a pool of distinct phantom volumes
made on the device in set-up. The mix's parameters: ``batch``, ``pool``,
``chunk`` (phantoms made per call), ``warmup_requests``,
``check_requests`` drawn from the seed among the first ``check_within``
(the last request is checked too), ``trace_requests`` [from, to) profiled.

The check: the worst slice's relative L2 error of the measurement, the
direct recon and the recon of every checked request, against the
reference on the same weights and images.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import phantoms as ph
from portbench.loops import CHECK_STREAM, POOL_STREAM, TracedSlice, sync
from portbench.reference.precision import CONTROL

__all__ = ["make_pool", "loop", "compare", "controls"]


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["pool"]`` distinct volumes of ``batch`` phantoms each
    (complex where the geometry is), made in chunks on the device."""
    g, tc = cfg["geometry"], cfg["train"]
    B, N, chunk = traffic["batch"], g["image_size"], traffic.get("chunk", 16)
    make = ph.complex_phantoms if g["kind"] == "radial" else ph.phantoms
    pool = []
    for v in range(traffic["pool"]):
        gen = ph.generator(device, ph.derive_seed(seed, POOL_STREAM, v))
        pool.append(torch.cat([make(gen, min(chunk, B - b0), N, tc["n_ellipses"],
                                    g["pixel_spacing"], device=device)
                               for b0 in range(0, B, chunk)]))
    return pool


def loop(run, task, seed: int, seconds: float, trace: bool) -> dict:
    traffic, device = run.traffic, run.device
    B = traffic["batch"]
    pool = make_pool(run.cfg, traffic, seed, device)
    rng = random.Random(ph.derive_seed(seed, CHECK_STREAM))
    keep = set(rng.sample(range(traffic["check_within"]), traffic["check_requests"]))
    shape = (B, run.cfg["geometry"]["image_size"], run.cfg["geometry"]["image_size"])
    pin = device.type == "cuda"
    ring = [torch.empty(shape, pin_memory=pin) for _ in range(2)]
    kept_host = {r: torch.empty(shape, pin_memory=pin) for r in keep}
    task.model.eval()

    def request(r: int, host):
        with torch.inference_mode():
            batch = task.batch_from_images(pool[r % len(pool)])
            recon = task.recon_fn(task.model, batch)
            host.copy_(recon, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(device).synchronize()
        return batch

    for w in range(traffic["warmup_requests"]):
        request(w, ring[w % 2])
    sync(device)
    t_lo, t_hi = traffic["trace_requests"]
    run.setup_end()
    lat, kept, last, traced = [], {}, None, None
    t0 = time.perf_counter()
    r = 0
    while True:
        if trace and r == t_lo:
            traced = TracedSlice(device)
            traced.start()
        ts = time.perf_counter()
        host = kept_host.get(r, ring[r % 2])
        batch = request(r, host)
        lat.append(time.perf_counter() - ts)
        last = (r, host, batch["sino"], batch["f0"])
        if r in keep:
            kept[r] = last[1:]
        r += 1
        if traced is not None and r == t_hi:
            run.trace = traced.stop()
            run.trace_units = (t_hi - t_lo) * B
            traced = None
        if time.perf_counter() - t0 >= seconds and (not trace or r >= t_hi):
            break
    run.elapsed = time.perf_counter() - t0
    run.latencies = lat
    run.units = len(lat) * B
    run.attempted = len(lat)
    if trace:
        untraced = [x for i, x in enumerate(lat) if not t_lo <= i < t_hi]
        run.untraced_rate = len(untraced) * B / sum(untraced)
    run.read_memory()
    kept[last[0]] = last[1:]
    # the program's outputs as produced, with the images they came from
    return {rr: {"images": pool[rr % len(pool)], "recon": host.clone(), "sino": sino.cpu(),
                 "f0": f0.cpu()} for rr, (host, sino, f0) in kept.items()}


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """Worst slice of ‖a − r‖ / ‖r‖ over the leading axis."""
    a, r = a.reshape(a.shape[0], -1), r.reshape(r.shape[0], -1)
    return float(((a - r).abs().norm(dim=1) / r.abs().norm(dim=1)).max())


def _numbers(ref, kept: dict, weights: dict, prec=None) -> dict:
    """Worst slice of each output against the reference, over the checked
    requests; ``prec`` puts the reference in the program's place."""
    sigma = ref.sigma()
    worst = {"sino_err": 0.0, "f0_err": 0.0, "recon_err": 0.0}
    for out in kept.values():
        want = ref.recon_volume(weights, out["images"], sigma)
        got = out if prec is None else ref.recon_volume(weights, out["images"],
                                                        ref.sigma(prec.lo), prec)
        for key in ("sino", "f0", "recon"):
            worst[f"{key}_err"] = max(worst[f"{key}_err"], _rel(got[key], want[key]))
    return worst


def compare(run, ref, prog: dict, weights: dict) -> dict:
    return _numbers(ref, prog, weights)


def controls(run, ref, prog: dict, weights: dict) -> dict:
    """The control's numbers: the reference in the program's place, one
    precision below the configuration's."""
    return {"control": _numbers(ref, prog, weights, CONTROL)}
