"""A cell on several cards: ``run.py`` starts one process a card, each with
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and a rendezvous on localhost, and
waits for every one. The ranks join the program's process group
(``var_tpu_torch.parallel.mesh.initialize_distributed``, NCCL) and a data
mesh over all of them; a gloo group beside it carries the host's decisions
(when the window ends, what each rank read), so that no rank waits on a
card for them. Rank 0 prints the result."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

RANK_ENV = "VAR_BENCH_T0_EPOCH"  # the launcher's start, so each rank's set-up counts from it


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(script: str, argv: list, chips: int, t0_epoch: float) -> int:
    """Run ``chips`` ranks of ``script argv``; relay rank 0's standard
    output when every rank exits with 0, else return the first failure."""
    port = free_port()
    procs = []
    for r in range(chips):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(chips),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), **{RANK_ENV: repr(t0_epoch)})
        procs.append(subprocess.Popen([sys.executable, script, *argv], env=env,
                                      stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL))
    try:
        while any(p.poll() is None for p in procs):  # a failed rank stops the others
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:  # a rank left behind is stopped and waited for
            if p.poll() is None:
                p.kill()
            p.wait()
    out = procs[0].stdout.read()
    procs[0].stdout.close()
    rcs = [p.returncode for p in procs]
    bad = [rc for rc in rcs if rc != 0]
    if bad:
        print(f"rank exit codes {rcs}", file=sys.stderr)
        return bad[0]
    sys.stdout.write(out.decode())
    sys.stdout.flush()
    return 0


def rank_t0() -> float:
    """The launcher's start on this process's host clock."""
    return time.perf_counter() - (time.time() - float(os.environ[RANK_ENV]))


def join(ctx, backend: str = "nccl") -> None:
    """Join the group and make the data mesh; fills ``ctx``'s rank fields."""
    import torch
    import torch.distributed as dist

    from var_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(backend)
    ctx.rank, ctx.world = dist.get_rank(), dist.get_world_size()
    ctx.mesh = make_mesh(1)
    ctx.host_group = dist.new_group(backend="gloo")
    if torch.cuda.is_available() and backend == "nccl":
        ctx.device = torch.device("cuda", torch.cuda.current_device())


def agree(ctx, value: bool) -> bool:
    """Rank 0's ``value`` on every rank (through the host group)."""
    if ctx.world == 1:
        return value
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(value)])
    dist.broadcast(flag, 0, group=ctx.host_group)
    return bool(flag.item())


def gather(ctx, obj) -> list:
    """Every rank's ``obj``, on every rank (through the host group)."""
    if ctx.world == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * ctx.world
    dist.all_gather_object(out, obj, group=ctx.host_group)
    return out


def leave(ctx) -> None:
    """Leave the process group, if this rank joined one, once every rank
    is done (rank 0 checks its steps against the reference first)."""
    if ctx.world > 1:
        import torch.distributed as dist

        dist.barrier(group=ctx.host_group)
        dist.destroy_process_group()
