"""Worlds of gloo ranks on the CPU for the port's multi-rank tests.

:func:`start_world` (and :func:`run_world`, which waits) starts ``world`` Python processes of this file, each one
rank (``torch.set_num_threads(1)``, a ``FileStore`` under the caller's
directory, so concurrent test workers cannot collide on a port), which
calls ``fn(rank, world, inputs)``, named ``"module:fn"``, and
saves what it returns (a dict) with ``torch.save``.  The spawn fails
instead of hanging: every rank has the same timeout, and a rank that
fails ends the world.  Returns rank 0's results.
"""
import importlib
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def run_world(world: int, target: str, workdir: str, inputs=None,
              timeout: float = 120.0):
    """Start a world and wait for it: rank 0's results."""
    return start_world(world, target, workdir, inputs, timeout).wait()


class World:
    """A started world of ranks; :meth:`wait` for its rank 0 results."""

    def __init__(self, procs, logs, workdir, timeout):
        self.procs, self.logs, self.workdir = procs, logs, workdir
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def wait(self):
        import torch
        procs, world = self.procs, len(self.procs)
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > self.deadline:
                    failed = (f"world of {world} timed out after "
                              f"{self.timeout} s")
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        if failed:
            tails = []
            for rank in range(world):
                with open(os.path.join(self.workdir, f"rank{rank}.log")) as f:
                    tails.append(f"--- rank {rank}\n" + f.read()[-3000:])
            raise RuntimeError(failed + "\n" + "\n".join(tails))
        return torch.load(os.path.join(self.workdir, "result0.pt"),
                          weights_only=False)


def start_world(world: int, target: str, workdir: str, inputs=None,
                timeout: float = 120.0) -> World:
    """Start ``world`` rank processes running ``target`` (``"module:fn"``)
    on ``inputs``; returns at once."""
    import torch
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    store = os.path.join(workdir, "store")
    for stale in [store] + [os.path.join(workdir, f"result{r}.pt")
                            for r in range(world)]:
        if os.path.exists(stale):
            os.remove(stale)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), target, str(rank),
             str(world), store, workdir],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=workdir))
    return World(procs, logs, workdir, timeout)


def _worker(target: str, rank: int, world: int, store: str, workdir: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            weights_only=False)
        module, fn = target.split(":")
        out = getattr(importlib.import_module(module), fn)(rank, world,
                                                           inputs)
        torch.save(out, os.path.join(workdir, f"result{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import warnings
    warnings.filterwarnings("ignore")
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5])
