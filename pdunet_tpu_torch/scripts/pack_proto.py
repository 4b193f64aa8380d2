"""Probe: the packed per-angle kernels on the tensor cores, with T̂ and φ
made on chip, against the shipped tensor-core routes that read trig tables.

Counterpart of ``scripts/pack_proto.py``, which packs re/im into one
(N, 2K) operand [T̂c | T̂s]: stage 1 is one product, stage 2 folds into two
2K-wide rows, stage 3 is one 4K-deep product (the adjoint contracts the
packed 2K once). Here, per operand type, on the x group of a plan:

  shipped     — ``project_group`` / ``backproject_group`` with the plan's
                trig tables (bf16: ``radon_group_tc.cu``; float32: the
                split-bf16 ``radon_group_split.cu``), built before timing;
  packed      — ``project_group_packed`` / ``backproject_group_packed``
                (``radon_proto_tc.cu``: ``wgmma``, T̂ and φ computed on chip
                from the plan rows, no table) with its trig rule: block
                doubling with bf16 operands, exact in float32;
  packed exact — the same kernels with exact trig (bf16 only).

It checks packed against shipped (bf16 with exact trig ≤ 5e-3, float32
≤ 1e-5, relative norm), prints the tables' build time on its own line, and
times each call by CUDA events, as a ratio to shipped. On the card, the
radial-dense plan also times the shipped float32 adjoint's table probe (a
test-only build of ``radon_proto_tc.cu``): a copy of its body reading its
own tables (checked against shipped, ≤ 1e-5), the copy with every chunk's
T̂ / φ reads pointed at one table chunk (the bytes cross from L2, staying
resident there) and with no table read at all (wrong numbers, the time
the table costs), the last two also as ratios to the copy.

    python -m pdunet_tpu_torch.scripts.pack_proto [--plan P]   # on the card
    python -m pdunet_tpu_torch.scripts.pack_proto --cpu        # plain versions at 32², no timing

Plans: ``flagship`` (256², 90 of 360 angles, x group, batch 32),
``radial`` (``pdunet_radial``'s 128-spoke fourier-slice plan, B' = 8) and
``radial-dense`` (``sino_unet_radial``'s dense 512-spoke plan, B' = 8 and
128). ``--cpu`` builds each at 32² (batch 2).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
import time

import torch

from pdunet_tpu_torch.bench import device_kind, timeit
from pdunet_tpu_torch.ops.radon.cuda_kernels import (
    _tc_dims,
    backproject_group,
    build_group_split_tables,
    build_group_tables,
    group_adjoint_splits,
    project_group,
)
from pdunet_tpu_torch.ops.radon.proto_kernels import (
    backproject_group_packed,
    project_group_packed,
)
from pdunet_tpu_torch.scripts.trig_proto import setup

PLANS = ("flagship", "radial", "radial-dense")
TOL = {"bfloat16": 5e-3, "float32": 1e-5}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def plan_for(name: str, device, small: bool):
    """(per-angle plan, batches) of a probe plan; ``small``: at 32²."""
    if name == "flagship":
        plan, f = setup(device, small=small)
        return plan, (f.shape[0],)
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.ops.nufft.fourier_slice import build_fs_plan
    from pdunet_tpu_torch.training.tasks import build_geometries

    preset = "pdunet_radial" if name == "radial" else "sino_unet_radial"
    gc = get_preset(preset).geometry
    if small:
        gc = dataclasses.replace(gc, image_size=32, n_angles=96)
    dense, sparse = build_geometries(gc)
    plan = build_fs_plan(sparse if name == "radial" else dense, device=device).par_plan
    if small:
        return plan, (2,)
    return plan, ((8,) if name == "radial" else (8, 128))


#: the table probe's variants of the shipped float32 adjoint, by the C
#: entry point's mode
TABLE_PROBES = {"shipped_copy": 0, "shipped_onetile": 1, "shipped_notable": 2}


def _table_probe_adjoint(plan, tables, N, mode: int):
    """The shipped float32 adjoint's body as copied into
    ``radon_proto_tc.cu`` built with ``PROTO_TC_TABLE_PROBE``: reading its
    own tables (mode 0, an adjoint), every chunk's reads pointed at one
    chunk (1) or left out (2); the last two give wrong numbers, the time
    without the table's L2 misses or without its bytes."""
    from pdunet_tpu_torch.ops.radon._build import load_library

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = load_library("radon_proto_tc", ("PROTO_TC_TABLE_PROBE",)
                      ).radon_proto_tc_tableprobe_backproject
    fn.restype, fn.argtypes = I, [P] * 8 + [I] * 10 + [P]
    m = plan.meta
    K, S, A = plan.Wc.shape[0], plan.Wc.shape[1], m["A_x"]
    Np, K2p = _tc_dims(N, K)
    T, phi = tables

    def call(p):
        B = p.shape[0]
        G = group_adjoint_splits(B, N, A, torch.cuda.get_device_properties(p.device)
                                 .multi_processor_count, 128)
        out = torch.empty((B, N, N), dtype=torch.float32, device=p.device)
        shat = torch.empty((B, A, K2p // 2, 2), dtype=torch.float32, device=p.device)
        part = torch.empty((G, B, N, N), dtype=torch.float32, device=p.device) if G > 1 else None
        rc = fn(p.data_ptr(), T.data_ptr(), phi.data_ptr(), plan.Wc.data_ptr(),
                plan.Ws.data_ptr(), shat.data_ptr(), None if part is None else part.data_ptr(),
                out.data_ptr(), B, N, Np, A, K, K2p // 2, S, G, 1, mode,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"table-probe adjoint: CUDA error {rc} at launch")
        return out

    return call


def run(plan_name: str = "flagship", device="cuda") -> dict:
    """Checks, and on the card timings, of one probe plan; returns the
    JSON record (also printed as the last line)."""
    device = torch.device(device)
    cpu = device.type == "cpu"
    plan, batches = plan_for(plan_name, device, small=cpu)
    m = plan.meta
    N, S, L, A = m["N"], m["S"], m["S_ext"], m["A_x"]
    print(f"plan {plan_name}: N={N} K={m['K']} S={S} S_ext={L} A_x={A} batches {batches} "
          f"on {device_kind(device)}")
    rows = (plan.pos_x, plan.shift_x, plan.spec, plan.Wc, plan.Ws, L, True)
    targs = (plan.pos_x, plan.shift_x, plan.spec, L)
    bf16, f32 = torch.bfloat16, torch.float32
    record = {"probe": "pack_proto", "plan": plan_name, "device": device_kind(device),
              "N": N, "A": A, "K": m["K"], "S": S}
    tables, build_ms = {}, {}
    for cdt, build in ((bf16, build_group_tables), (f32, build_group_split_tables)):
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
            gen = torch.Generator(device=device).manual_seed(0)
            f = torch.randn(B, N, N, generator=gen, device=device)
            p = torch.randn(B, A, S, generator=gen, device=device)
            rec = record[f"B{B}"] = {}
            for cdt in (bf16, f32):
                name = str(cdt).split(".")[1]
                tab = tables[cdt]
                variants = {
                    "fwd": {
                        "shipped": lambda x, c=cdt, t=tab: project_group(x, *rows, c, tables=t),
                        "packed": lambda x, c=cdt: project_group_packed(x, *rows, c),
                        "packed_exact": lambda x, c=cdt: project_group_packed(
                            x, *rows, c, doubling=False),
                    },
                    "adj": {
                        "shipped": lambda y, c=cdt, t=tab: backproject_group(
                            y, *rows, N, c, tables=t),
                        "packed": lambda y, c=cdt: backproject_group_packed(y, *rows, N, c),
                        "packed_exact": lambda y, c=cdt: backproject_group_packed(
                            y, *rows, N, c, doubling=False),
                    },
                }
                if cdt == f32:  # float32's own rule is exact trig
                    for v in variants.values():
                        del v["packed_exact"]
                if cdt == f32 and not cpu and plan_name == "radial-dense":
                    for key, mode in TABLE_PROBES.items():
                        variants["adj"][key] = _table_probe_adjoint(plan, tab, N, mode)
                out = rec[name] = {}
                for op, fns in variants.items():
                    x = f if op == "fwd" else p
                    # bf16: exact trig is the shipped route's trig; f32: its own rule
                    err = rel(fns["packed_exact" if cdt == bf16 else "packed"](x),
                              fns["shipped"](x))
                    print(f"{op} packed rel-err against shipped ({name}, exact trig, B={B}): "
                          f"{err:.3e} (tol {TOL[name]:.0e})")
                    if not err <= TOL[name]:
                        raise AssertionError(f"packed {op} disagrees with shipped in {name} at "
                                             f"B={B}: {err} (tol {TOL[name]})")
                    out[op] = {"rel_err": err}
                    if "shipped_copy" in fns:
                        err = rel(fns["shipped_copy"](x), fns["shipped"](x))
                        print(f"{op} table-probe copy rel-err against shipped ({name}, B={B}): "
                              f"{err:.3e} (tol {TOL[name]:.0e})")
                        if not err <= TOL[name]:
                            raise AssertionError(f"the table-probe copy of the shipped {op} "
                                                 f"disagrees with it at B={B}: {err}")
                        out[op]["copy_rel_err"] = err
                    if cpu:
                        continue
                    ms = {k: timeit(fn, x, iters=1) * 1e3 for k, fn in fns.items()}
                    ratios = {k: ms["shipped"] / v for k, v in ms.items() if k != "shipped"}
                    out[op].update({f"{k}_ms": v for k, v in ms.items()})
                    out[op].update({f"speedup_{k}": v for k, v in ratios.items()})
                    print(f"{op} {name} B={B}: " + ", ".join(
                        f"{k} {v:.4f} ms" + (f" ({ratios[k]:.3f}x)" if k in ratios else "")
                        for k, v in ms.items()))
                    if "shipped_copy" in ms:
                        vs_copy = {k: ms["shipped_copy"] / ms[k]
                                   for k in ("shipped_onetile", "shipped_notable")}
                        out[op].update({f"{k}_vs_copy": v for k, v in vs_copy.items()})
                        print(f"{op} {name} B={B} table probe against the copy: " + ", ".join(
                            f"{k} {v:.3f}x" for k, v in vs_copy.items()))
            del f, p
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
