"""Launch training over several processes.

Counterpart of `trackformer_tpu/cli/submit.py` (the original's
`run_with_submitit.py`): joins the process group that the launcher's
environment describes (`parallel/dist.py`: torchrun's `RANK` /
`WORLD_SIZE` / `LOCAL_RANK` / `MASTER_ADDR` / `MASTER_PORT`, or the JAX
launcher's `COORDINATOR_ADDRESS` / `NUM_PROCESSES` / `PROCESS_ID`), turns
on auto-resume (`resume_optim=true` unless given: a preempted run restarts
from the newest checkpoint in `output_dir`) and enters the training CLI.

Usage, one process per rank:
  torchrun --nproc_per_node=N -m trackformer_tpu_torch.cli.submit \\
      with [train named configs] k=v ...
On one card several ranks share it over gloo; with a card per rank they
run over NCCL (`parallel.dist.choose_backend`). `submit.*` overrides (the
JAX launcher's host counts) are dropped.
"""
from __future__ import annotations

import sys


def main(argv=None, device="cuda"):
    """Join the process group and train -> the training CLI's result."""
    from ..parallel import dist as pdist
    from .train import main as train_main

    argv = list(sys.argv[1:] if argv is None else argv)
    train_argv = [a for a in argv if not a.startswith("submit.")]
    device = pdist.init_process_group(device)
    if not any(a.startswith("resume_optim") for a in train_argv):
        train_argv.append("resume_optim=true")
    return train_main(train_argv, device=device)


if __name__ == "__main__":
    main()
