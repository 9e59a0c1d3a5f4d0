"""Start the ranks of a process group on this host and reap them (PyTorch
port).

:func:`run_ranks` starts ``world`` processes of one command, each with
torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and the repo
root on ``PYTHONPATH``, writes each rank's output to ``rank<r>.log`` in a
directory of the caller's, waits until every rank has ended or the deadline
has passed, kills the ranks still running and raises with the failed ranks'
output. The command brings its own rendezvous (a ``file://`` store in that
directory: no port), so several groups can run side by side.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(cmd: Sequence[str], world: int, log_dir: str, timeout: float,
              env: Optional[Dict[str, str]] = None, what: str = "ranks") -> List[str]:
    """Run ``cmd`` as ranks 0..world-1 from the repo root, with ``env`` added
    to this process's environment (less any ``MASTER_ADDR`` / ``MASTER_PORT``
    / ``COORDINATOR_ADDRESS``); return each rank's output. Raises
    ``RuntimeError`` naming ``what`` with the failed ranks' exit codes and
    the ends of their output if one fails or the group outlives ``timeout``
    seconds (every rank still running is then killed)."""
    os.makedirs(log_dir, exist_ok=True)
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS")}
    base.update(env or {}, WORLD_SIZE=str(world),
                PYTHONPATH=os.pathsep.join([REPO, base.get("PYTHONPATH", "")]))
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(os.path.join(log_dir, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                list(cmd), cwd=REPO, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"{what}: ranks {bad} failed or timed out after {timeout} s (exit codes "
            f"{[p.returncode for p in procs]}):\n"
            + "\n".join(f"--- rank {r}\n{outputs[r][-6000:]}" for r in bad))
    return outputs
