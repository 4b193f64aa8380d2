"""Probe: how much of the mirror-pair forward kernel is trig on the card?

Counterpart of ``scripts/trig_proto.py``. The pair forward generates six
(N, K) trig tensors per angle pair. This A/Bs three forward kernels at the
flagship plan shape (256², 90 of 360 angles, x group, batch 32, bf16
operands):

  A. shipped  — precise sincosf per element (the pair forward's CUDA-core
                kernel, ``_project_pair_cc``: like with like beside B and C;
                ``project_pair_group``'s bf16 route now runs on the tensor
                cores from per-plan trig tables)
  B. no-trig  — trig tensors replaced by mul-adds of the same shape (same
                products; the time if trig were free: wrong numbers)
  C. doubling — trig from per-pair seeds by block-doubling rotors
                (``project_pair_group_doubling``; error ~N·eps_f32)

and prints the free-trig bound t_A / t_B and what doubling recovers,
t_A / t_C, with CUDA-event times per call and the card's name.

    python -m pdunet_tpu_torch.scripts.trig_proto          # on the card
    python -m pdunet_tpu_torch.scripts.trig_proto --cpu    # plain versions, 32², no timing
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from pdunet_tpu_torch.bench import device_kind, timeit
from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.radon.cuda_kernels import _project_pair_cc, project_pair_group
from pdunet_tpu_torch.ops.radon.proto_kernels import (
    phase_seeds,
    project_pair_group_doubling,
    project_pair_group_notrig,
)


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |b|, the JAX script's error measure."""
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def setup(device, small: bool = False):
    """The flagship plan (256², 90 of 360 angles, bf16 operands) and a seeded
    batch of 32 images; ``small``: 32², 24 of 96 angles, batch 2."""
    size, n_angles, batch = (32, 96, 2) if small else (256, 360, 32)
    geom = ParallelGeometry(image_size=size, n_angles=n_angles).subsample(4)
    plan = build_parallel_plan(geom, dtype=torch.bfloat16, device=device)
    f = torch.randn(batch, size, size,
                    generator=torch.Generator(device=device).manual_seed(0), device=device)
    return plan, f


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU at 32², batch 2, no timing")
    args = p.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    plan, f = setup(device, small=args.cpu)
    m = plan.meta
    K, L = m["K"], m["S_ext"]
    print(f"plan: K={K} S={m['S']} S_ext={L} P_x={m['P_x']} P_y={m['P_y']} "
          f"B={f.shape[0]} on {device_kind(device)}")
    rows = [getattr(plan, f"pair_{nm}_x") for nm in ("pos", "sha", "shb", "sgn")]
    seeds = [torch.from_numpy(s).to(device) for s in phase_seeds(*rows[:3], K, L)]
    cdt = torch.bfloat16

    def shipped(x):
        fn = project_pair_group if x.device.type == "cpu" else _project_pair_cc
        return fn(x, *rows, plan.spec, plan.Wc, plan.Ws, L, True, cdt)

    def notrig(x):
        return project_pair_group_notrig(x, *rows, plan.spec, plan.Wc, plan.Ws, L, True, cdt)

    def doubling(x):
        return project_pair_group_doubling(x, *seeds, rows[3], plan.spec, plan.Wc, plan.Ws,
                                           True, cdt)

    with torch.inference_mode():
        err = rel_max(doubling(f), shipped(f))
    print(f"doubling vs shipped rel-err: {err:.3e}")
    if not err < 2e-2:
        raise AssertionError(f"doubling disagrees with the shipped kernel: {err}")
    if args.cpu:
        print("CPU correctness done (no timing).")
        return 0

    t_a, t_b, t_c = (timeit(fn, f, iters=50) for fn in (shipped, notrig, doubling))
    print(f"fwd shipped  {t_a * 1e3:.4f} ms")
    print(f"fwd no-trig  {t_b * 1e3:.4f} ms  ({t_a / t_b:.3f}x free-trig bound)")
    print(f"fwd doubling {t_c * 1e3:.4f} ms  ({t_a / t_c:.3f}x)")
    print(json.dumps({"probe": "trig_proto", "device": device_kind(device),
                      "shipped_ms": t_a * 1e3, "notrig_ms": t_b * 1e3,
                      "doubling_ms": t_c * 1e3, "free_trig_bound": t_a / t_b,
                      "doubling_speedup": t_a / t_c, "doubling_rel_err": err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
