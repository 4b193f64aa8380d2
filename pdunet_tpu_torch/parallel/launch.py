"""Start the ranks of a mesh as processes (JAX drives every device of a
mesh from one process; PyTorch runs one process per rank).

``launch("pdunet_tpu_torch.train", argv, 4)`` runs ``python -m
pdunet_tpu_torch.train *argv`` four times with torchrun's environment
contract (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``)
and a ``file://`` rendezvous in a fresh temporary directory
(``PDUNET_INIT_METHOD``, read by ``sharding.init_distributed``), which no
other launch can collide with, as a TCP port could. The same module runs
under ``torchrun --nproc-per-node 4 -m pdunet_tpu_torch.train ...``.

As torchrun does, each rank runs one intra-op thread unless
``OMP_NUM_THREADS`` says otherwise. Rank 0's standard output is the
launcher's; every rank's standard error goes to a log file, and rank 0's
is copied to the launcher's at the end.
The first rank that exits with a non-zero code fails the launch with its
code and the end of its log; the others are then killed. ``timeout_s``
bounds the wait for all of them.

``add_dist_args`` and ``run_ranks`` give an entry point (``train``,
``infer``) its flags and its two roles: the launching process, and a rank.
A rank of such a run fails when a collective waits longer than
``--dist-timeout`` (the process group's timeout), and, unless
``--watchdog-secs`` says otherwise, when it makes no progress (a train step,
an eval batch) for as long (its watchdog, ``utils/watchdog.py``: 2× that
before the first step): so a rank that hangs, in a collective or outside
one, exits, and its exit fails the launch.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

from pdunet_tpu_torch.parallel.sharding import DEFAULT_TIMEOUT_S, init_distributed

__all__ = ["launch", "RankFailed", "add_dist_args", "run_ranks"]

#: the directory that holds the ``pdunet_tpu_torch`` package
_ROOT = str(pathlib.Path(__file__).resolve().parents[2])


class RankFailed(RuntimeError):
    """A rank of a launch exited with a non-zero code, or the launch timed out."""


def _tail(path: pathlib.Path, n: int = 4000) -> str:
    data = path.read_bytes()
    return data[-n:].decode(errors="replace")


def launch(module: str, argv: Sequence[str], world_size: int,
           timeout_s: Optional[float] = None) -> int:
    """Run ``python -m module *argv`` as ``world_size`` ranks on this host
    and wait for all of them (at most ``timeout_s`` seconds when given).
    Returns 0; raises :class:`RankFailed` for the first rank that fails."""
    with tempfile.TemporaryDirectory(prefix="pdunet-launch-") as tmp:
        tmp = pathlib.Path(tmp)
        # torchrun's default: one intra-op thread per rank unless the caller says
        base = {"OMP_NUM_THREADS": "1", **os.environ}
        base.update(WORLD_SIZE=str(world_size), LOCAL_WORLD_SIZE=str(world_size),
                    PDUNET_INIT_METHOD=f"file://{tmp / 'rendezvous'}",
                    PYTHONPATH=os.pathsep.join(
                        [_ROOT] + [p for p in [base.get("PYTHONPATH")] if p]))
        logs = [tmp / f"rank{r}.log" for r in range(world_size)]
        procs = []
        try:
            for r in range(world_size):
                with open(logs[r], "wb") as err, open(os.devnull, "wb") as null:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", module, *argv],
                        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                        stdout=None if r == 0 else null, stderr=err,
                        stdin=subprocess.DEVNULL))
            deadline = None if timeout_s is None else time.monotonic() + timeout_s
            pending = set(range(world_size))
            while pending:
                for r in sorted(pending):
                    rc = procs[r].poll()
                    if rc is None:
                        continue
                    pending.discard(r)
                    if rc != 0:
                        raise RankFailed(f"rank {r} of {world_size} ({module}) exited with "
                                         f"code {rc}:\n{_tail(logs[r])}")
                if deadline is not None and time.monotonic() > deadline:
                    raise RankFailed(f"{module}: ranks {sorted(pending)} of {world_size} "
                                     f"still running after {timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            if logs[0].exists():
                sys.stderr.write(logs[0].read_text(errors="replace"))
    return 0


def add_dist_args(p) -> None:
    """The flags of a run over several ranks (``train``, ``infer``)."""
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="collective backend of a mesh (default: nccl on cards, gloo on "
                        "the CPU; gloo for ranks that share a card)")
    p.add_argument("--dist-timeout", type=float, default=DEFAULT_TIMEOUT_S,
                   help="seconds a collective may wait, and a rank may go without "
                        "progress unless --watchdog-secs is set, before the run fails")


def run_ranks(module: str, args, argv, world: int) -> Optional[int]:
    """In the launching process of a ``world``-rank run: start the ranks
    (``python -m module argv``) and return 0 once all succeed; in a rank:
    join the process group, set ``args.device`` to the rank's device, arm
    the watchdog at ``--dist-timeout`` when ``--watchdog-secs`` is 0, and
    return None (also for ``world`` = 1, which runs in this process)."""
    if world == 1:
        return None
    if "RANK" not in os.environ:  # the launching process, not a rank
        return launch(module, sys.argv[1:] if argv is None else list(argv), world)
    if int(os.environ["WORLD_SIZE"]) != world:
        raise SystemExit(f"{world} ranks asked for, WORLD_SIZE is {os.environ['WORLD_SIZE']}")
    args.device = str(init_distributed(args.device, args.dist_backend, args.dist_timeout))
    args.watchdog_secs = args.watchdog_secs or args.dist_timeout
    return None
