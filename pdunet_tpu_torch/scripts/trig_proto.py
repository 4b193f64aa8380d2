"""Probe: what do the trig tables cost the mirror-pair forward on the card?

Counterpart of ``scripts/trig_proto.py``. The pair forward uses six (N, K)
trig tensors per angle pair; the shipped tensor-core routes read them from
per-plan tables. Per operand type, on the x group of a plan, this A/Bs:

  shipped     — ``project_pair_group`` with the plan's trig tables (bf16:
                ``build_pair_tables`` for ``radon_pair_tc.cu``; float32:
                ``build_pair_split_tables`` for the split-bf16
                ``radon_pair_split.cu``), built before timing;
  doubling-tc — ``project_pair_group_doubling`` (``radon_pair_proto_tc.cu``:
                ``wgmma``, T̂ and both members' φ made on chip by block
                doubling from per-pair seeds, no table read);
  no-trig-tc  — ``project_pair_group_notrig`` (the same kernels with the trig
                replaced by mul-adds of the same shape: no table read and no
                trig, wrong numbers).

It checks doubling against shipped (max |Δ| / max |shipped| < 2e-2, the JAX
script's check), prints the tables' build time on its own line, and times
each call by CUDA events, as a ratio to shipped. Two ratios are named: the
free-trig-and-table bound t_shipped / t_no-trig-tc, and the doubling speedup
t_shipped / t_doubling-tc.

    python -m pdunet_tpu_torch.scripts.trig_proto [--plan P]   # on the card
    python -m pdunet_tpu_torch.scripts.trig_proto --cpu        # plain versions at 32², no timing

Plans: ``flagship`` (256², 90 of 360 angles, batch 32), ``dense``
(``sino_unet_parallel``'s synthesis plan, all 360 angles, P = 91, batch 8
and 128) and ``fan`` (``pdunet_fan``'s backing plan, P = 30 with sign +1
pairs, S = 251, batch 4 and 128). ``--cpu`` builds each at 32² (batch 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from pdunet_tpu_torch.bench import device_kind, timeit
from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.radon.cuda_kernels import (
    build_pair_split_tables,
    build_pair_tables,
    project_pair_group,
)
from pdunet_tpu_torch.ops.radon.proto_kernels import (
    phase_seeds,
    project_pair_group_doubling,
    project_pair_group_notrig,
)

PLANS = ("flagship", "dense", "fan")
VARIANTS = ("shipped", "doubling_tc", "notrig_tc")


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


def plan_for(name: str, device, small: bool):
    """(pair plan, batches) of a probe plan; ``small``: at 32²."""
    if name == "flagship":
        plan, f = setup(device, small=small)
        return plan, (f.shape[0],)
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.ops.radon.fan import build_fan_plan
    from pdunet_tpu_torch.training.tasks import build_geometries

    gc = get_preset("sino_unet_parallel" if name == "dense" else "pdunet_fan").geometry
    if small:
        gc = dataclasses.replace(gc, image_size=32, n_angles=96 if name == "dense" else 40)
    dense, sparse = build_geometries(gc)
    if name == "dense":
        plan = build_parallel_plan(dense, device=device)
    else:
        plan = build_fan_plan(sparse, device=device).par_plan
    if small:
        return plan, (2,)
    return plan, ((8, 128) if name == "dense" else (4, 128))


def run(plan_name: str = "flagship", device="cuda") -> dict:
    """Checks, and on the card timings, of one probe plan; returns the
    JSON record (also printed as the last line)."""
    device = torch.device(device)
    cpu = device.type == "cpu"
    plan, batches = plan_for(plan_name, device, small=cpu)
    m = plan.meta
    N, K, S, L, P = m["N"], m["K"], m["S"], m["S_ext"], m["P_x"]
    print(f"plan {plan_name}: N={N} K={K} S={S} S_ext={L} P_x={P} batches {batches} "
          f"on {device_kind(device)}")
    rows = [getattr(plan, f"pair_{nm}_x") for nm in ("pos", "sha", "shb", "sgn")]
    seeds = [torch.from_numpy(s).to(device) for s in phase_seeds(*rows[:3], K, L)]
    consts = (plan.spec, plan.Wc, plan.Ws)
    targs = (*rows[:3], plan.spec, L)
    bf16, f32 = torch.bfloat16, torch.float32
    record = {"probe": "trig_proto", "plan": plan_name, "device": device_kind(device),
              "N": N, "P": P, "K": K, "S": S}
    tables, build_ms = {}, {}
    for cdt, build in ((bf16, build_pair_tables), (f32, build_pair_split_tables)):
        tables[cdt] = build(*targs)  # the first call also builds and loads the kernels
        if not cpu:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            tables[cdt] = build(*targs)
            torch.cuda.synchronize(device)
            build_ms[str(cdt).split(".")[1]] = (time.perf_counter() - t0) * 1e3
    if not cpu:
        print(f"tables of the x group built in {build_ms} ms per route (host clock to a "
              f"synchronize, warm)")
        record["table_build_ms"] = build_ms

    with torch.inference_mode():
        for B in batches:
            f = torch.randn(B, N, N, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
            rec = record[f"B{B}"] = {}
            for cdt in (bf16, f32):
                name = str(cdt).split(".")[1]
                fns = {
                    "shipped": lambda x, c=cdt: project_pair_group(
                        x, *rows, *consts, L, True, c, tables=tables[c]),
                    "doubling_tc": lambda x, c=cdt: project_pair_group_doubling(
                        x, *seeds, rows[3], *consts, True, c),
                    "notrig_tc": lambda x, c=cdt: project_pair_group_notrig(
                        x, *rows, *consts, L, True, c),
                }
                err = rel_max(fns["doubling_tc"](f), fns["shipped"](f))
                print(f"doubling vs shipped rel-err ({name}, B={B}): {err:.3e} (tol 2e-2)")
                if not err < 2e-2:
                    raise AssertionError(f"doubling disagrees with the shipped kernel in {name} "
                                         f"at B={B}: {err}")
                out = rec[name] = {"doubling_rel_err": err}
                if cpu:
                    continue
                ms = {k: timeit(fns[k], f, iters=1) * 1e3 for k in VARIANTS}
                ratios = {k: ms["shipped"] / v for k, v in ms.items() if k != "shipped"}
                out.update({f"{k}_ms": v for k, v in ms.items()})
                out.update({f"speedup_{k}": v for k, v in ratios.items()})
                out["free_trig_and_table_bound"] = ratios["notrig_tc"]
                out["doubling_speedup"] = ratios["doubling_tc"]
                print(f"fwd {name} B={B}: " + ", ".join(
                    f"{k} {v:.4f} ms" + (f" ({ratios[k]:.3f}x)" if k in ratios else "")
                    for k, v in ms.items()))
                print(f"fwd {name} B={B}: free-trig-and-table bound "
                      f"{out['free_trig_and_table_bound']:.3f}x, doubling speedup "
                      f"{out['doubling_speedup']:.3f}x")
            del f
    if cpu:
        print("CPU correctness done (no timing).")
    print(json.dumps(record))
    return record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--plan", choices=PLANS, default="flagship")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU at 32², batch 2, no timing")
    args = p.parse_args(argv)
    run(args.plan, "cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
