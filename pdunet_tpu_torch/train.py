"""Train entry point of the PyTorch port (port of ``train.py``).

Usage:
  python -m pdunet_tpu_torch.train --preset pdunet_parallel --steps 2000
  python -m pdunet_tpu_torch.train --preset pdunet_radial --ckpt-dir runs/rad --resume auto
  python -m pdunet_tpu_torch.train --preset sino_unet_parallel --steps 20 --metrics m.jsonl
  python -m pdunet_tpu_torch.train --preset pdunet_fan --steps 20 --ckpt-dir runs/fan
  python -m pdunet_tpu_torch.train --preset pdunet_parallel --data store --split train
  python -m pdunet_tpu_torch.train --preset pdunet_parallel --device cpu --steps 20 \\
      --set geometry.image_size=32 --set model.base_features=8
  python -m pdunet_tpu_torch.train --preset pdunet_parallel --devices 2 --angle-devices 2
  python -m pdunet_tpu_torch.train --preset pdunet_parallel --steps 200 --tb-dir runs/tb

Ported presets: all seven (``pdunet_parallel``, ``pdunet_radial``,
``fbp_unet_parallel``, ``sino_unet_parallel``, ``lpd_parallel``,
``pdunet_fan``, ``sino_unet_radial``); any config field
can be overridden with ``--set section.field=value``. Training runs on the
card (``--device cuda``) unless ``--device cpu`` is asked for. ``--data``
trains on the ground truth of a slice store (``data/datasets.py``: an npy
directory, or an ``.h5`` file where h5py is installed) and validates on its
``val`` split. ``--tb-dir`` writes TensorBoard scalars (the tensorboard
package must be installed).

``--devices D --angle-devices G`` trains on a (data, angle) mesh of D·G
ranks: this command starts them as processes (``parallel/launch.py``; or
run it under ``torchrun --nproc-per-node D·G``), each on
``cuda:(LOCAL_RANK % card count)`` or the CPU, joined by NCCL on cards and
gloo on the CPU (``--dist-backend gloo`` for ranks that share a card). The
batch is sharded over the data axis and, with G > 1, the operators over
the angle axis. ``--checkify`` and ``--dump-hlo`` are XLA tools with no
counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import sys

import torch

from pdunet_tpu_torch.configs import ExperimentConfig, get_preset
from pdunet_tpu_torch.parallel.launch import add_dist_args, run_ranks


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", help="preset name (pdunet_parallel, pdunet_radial, "
                   "fbp_unet_parallel, sino_unet_parallel, lpd_parallel, pdunet_fan, "
                   "sino_unet_radial)")
    p.add_argument("--config", help="path to an ExperimentConfig JSON")
    p.add_argument("--steps", type=int, default=None, help="override train.steps")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. train.learning_rate=3e-4")
    p.add_argument("--ckpt-dir", default=None, help="checkpoint directory")
    p.add_argument("--resume", choices=["auto", "none"], default="auto",
                   help="auto-resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--metrics", default=None, help="JSONL metrics output path")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 10-15 here, with the "
                        "program's spans (train.step and its phases, pd.dual / "
                        "pd.primal) as ranges beside the kernels")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: fail at the op whose "
                        "backward makes a NaN (slow)")
    p.add_argument("--dump-config", action="store_true",
                   help="print the resolved config JSON and exit")
    p.add_argument("--watchdog-secs", type=float,
                   default=float(os.environ.get("PDUNET_WATCHDOG_SECS", 0)),
                   help="abort (exit 87) if no training step completes for this many "
                        "seconds; the run resumes from the last checkpoint. 0 disables "
                        "(default; env PDUNET_WATCHDOG_SECS overrides)")
    p.add_argument("--data", default=None,
                   help="slice store to train on (npy directory, or .h5 with h5py); "
                        "else synthetic phantoms")
    p.add_argument("--split", default="train", help="dataset split for --data")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel: shard each batch over this many ranks")
    p.add_argument("--angle-devices", type=int, default=None,
                   help="angle-shard the operators over this many ranks per data shard")
    add_dist_args(p)
    p.add_argument("--tb-dir", default=None, help="write TensorBoard scalars here")
    # XLA tools of the reference: each raises
    p.add_argument("--checkify", action="store_true",
                   help="an XLA tool; no counterpart here (see --debug-nans)")
    p.add_argument("--dump-hlo", default=None, metavar="DIR",
                   help="an XLA tool; no counterpart here")
    return p.parse_args(argv)


def _refuse_unported(args):
    for flag, on in (("--checkify", args.checkify), ("--dump-hlo", args.dump_hlo)):
        if on:
            raise NotImplementedError(
                f"{flag} drives an XLA tool, which has no counterpart in the PyTorch "
                f"port (--debug-nans runs torch's anomaly detection)")


def resolve_config(args) -> ExperimentConfig:
    """The run's config: ``--preset`` or ``--config``, then ``--set`` and
    ``--ckpt-dir`` (the flags that ``infer`` shares)."""
    if args.config:
        config = ExperimentConfig.from_json(pathlib.Path(args.config).read_text())
    elif args.preset:
        config = get_preset(args.preset)
    else:
        raise SystemExit("need --preset or --config (try --preset pdunet_parallel)")
    overrides = dict(item.partition("=")[::2] for item in args.set)
    if overrides:
        config = config.override(overrides)
    if args.ckpt_dir is not None:
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, ckpt_dir=args.ckpt_dir))
    return config


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    config = resolve_config(args)
    world = (args.devices or 1) * (args.angle_devices or 1)
    if config.train.batch_size % (args.devices or 1):
        raise SystemExit(f"--devices {args.devices} must divide batch size "
                         f"{config.train.batch_size}")
    if args.resume == "none" and config.train.ckpt_dir:
        # a fresh run: refuse to clobber an existing run directory
        ckpt = pathlib.Path(config.train.ckpt_dir)
        if ckpt.exists() and any(ckpt.iterdir()):
            raise SystemExit(
                f"--resume none but {ckpt} is non-empty; remove it or use --resume auto")
    if args.dump_config:
        print(config.to_json())
        return 0
    if run_ranks("pdunet_tpu_torch.train", args, argv, world) == 0:
        return 0
    if args.watchdog_secs > 0:
        from pdunet_tpu_torch.utils import watchdog

        watchdog.start(args.watchdog_secs, label=f"train:{config.name}")

    from pdunet_tpu_torch.training.loop import train

    try:
        with torch.autograd.set_detect_anomaly(args.debug_nans):
            result = train(config, steps=args.steps, metrics_path=args.metrics, verbose=True,
                           profile_dir=args.profile_dir, device=args.device, data=args.data,
                           split=args.split, n_devices=args.devices,
                           angle_devices=args.angle_devices, tb_dir=args.tb_dir)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(f"[done] final eval: {result.final_eval}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
