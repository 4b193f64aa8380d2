"""Probe: does packing re/im into one product matter on the card?

Counterpart of ``scripts/pack_proto.py``. The shipped per-angle CUDA-core
kernels (``_project_group_cc`` / ``_backproject_group_cc``, the A/B baseline
of both tensor-core routes of ``project_group`` / ``backproject_group``)
derive ĝ_re and ĝ_im per thread from one load of F. The packed kernels run stage 1 over one (N, 2K) operand
[T̂c | T̂s], fold stage 2 into two 2K-wide rows and run stage 3 as one
4K-deep product (the adjoint contracts the packed 2K once). At the flagship
plan's x group (256², 90 of 360 angles, batch 32) this checks packed
against shipped (bf16: 2e-2, float32: 1e-5, max-abs relative) and times
shipped, packed with its own trig rule (block doubling in bf16) and packed
with exact trig (the shipped kernels' trig), forward and adjoint, by CUDA
events per call.

    python -m pdunet_tpu_torch.scripts.pack_proto          # on the card
    python -m pdunet_tpu_torch.scripts.pack_proto --cpu    # plain versions, 32², no timing
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from pdunet_tpu_torch.bench import device_kind, timeit
from pdunet_tpu_torch.ops.radon.cuda_kernels import (
    _backproject_group_cc,
    _project_group_cc,
    backproject_group,
    project_group,
)
from pdunet_tpu_torch.ops.radon.proto_kernels import (
    backproject_group_packed,
    project_group_packed,
)
from pdunet_tpu_torch.scripts.trig_proto import rel_max, setup


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU at 32², batch 2, no timing")
    args = p.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    plan, f = setup(device, small=args.cpu)
    m = plan.meta
    N, L = m["N"], m["S_ext"]
    print(f"plan: K={m['K']} S={m['S']} S_ext={L} A_x={m['A_x']} A_y={m['A_y']} "
          f"B={f.shape[0]} on {device_kind(device)}")
    rows = (plan.pos_x, plan.shift_x, plan.spec, plan.Wc, plan.Ws, L, True)

    # "shipped": the per-angle CUDA-core kernels (like with like beside the
    # packed ones; both of project_group's routes now run on the tensor cores)
    def shipped_fwd(x, cdt):
        fn = project_group if x.device.type == "cpu" else _project_group_cc
        return fn(x, *rows, cdt)

    def shipped_adj(x, cdt):
        if x.device.type == "cpu":
            return backproject_group(x, *rows, N, cdt)
        return _backproject_group_cc(x, *rows, N, cdt)

    p = torch.randn(f.shape[0], m["A_x"], m["S"],
                    generator=torch.Generator(device=device).manual_seed(1), device=device)
    errs = {}
    with torch.inference_mode():
        for cdt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            name = str(cdt).split(".")[1]
            err = rel_max(project_group_packed(f, *rows, cdt), shipped_fwd(f, cdt))
            erra = rel_max(backproject_group_packed(p, *rows, N, cdt), shipped_adj(p, cdt))
            print(f"fwd packed rel-err ({name}): {err:.3e}")
            print(f"adj packed rel-err ({name}): {erra:.3e}")
            if not (err < tol and erra < tol):
                raise AssertionError(f"packed disagrees with shipped in {name}: "
                                     f"fwd {err}, adj {erra} (tol {tol})")
            errs[name] = (err, erra)
    if args.cpu:
        print("CPU correctness done (no timing).")
        return 0

    cdt = torch.bfloat16
    t = {
        "fwd_shipped": timeit(lambda x: shipped_fwd(x, cdt), f, iters=50),
        "fwd_packed": timeit(lambda x: project_group_packed(x, *rows, cdt), f, iters=50),
        "fwd_packed_exact": timeit(
            lambda x: project_group_packed(x, *rows, cdt, doubling=False), f, iters=50),
        "adj_shipped": timeit(lambda x: shipped_adj(x, cdt), p, iters=50),
        "adj_packed": timeit(lambda x: backproject_group_packed(x, *rows, N, cdt), p,
                             iters=50),
        "adj_packed_exact": timeit(
            lambda x: backproject_group_packed(x, *rows, N, cdt, doubling=False), p,
            iters=50),
    }
    for d in ("fwd", "adj"):
        old = t[f"{d}_shipped"]
        print(f"{d} shipped {old * 1e3:.4f} ms  packed {t[f'{d}_packed'] * 1e3:.4f} ms "
              f"({old / t[f'{d}_packed']:.3f}x)  packed exact-trig "
              f"{t[f'{d}_packed_exact'] * 1e3:.4f} ms ({old / t[f'{d}_packed_exact']:.3f}x)")
    print(json.dumps({"probe": "pack_proto", "device": device_kind(device),
                      **{f"{k}_ms": v * 1e3 for k, v in t.items()},
                      "rel_err": {k: list(v) for k, v in errs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
