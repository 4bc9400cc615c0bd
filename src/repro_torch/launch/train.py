"""End-to-end training.

    python -m repro_torch.launch.train --arch llama3.2-3b --smoke --steps 100
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-3b --smoke --model-axis 2

The port of ``repro.launch.train``, with its flags and summary line: the
model (smoke or full config) with weights from seed 0, AdamW
(``optim.adamw``), ``SyntheticTokens`` batches keyed by step, and the
fault-tolerant supervisor loop (checkpoint/restart, retries, straggler
stats) around ``runtime.steps.make_train_step``. It runs on cuda;
``main(argv, device="cpu")`` runs it on the CPU.

Under a process group (``torchrun``: one GPU a rank, NCCL; or gloo on the
CPU, the group made by the caller) it trains on ``make_host_mesh(
--model-axis)``: the parameters are placed by ``param_shardings``, the
moments by ``opt_shardings``, each batch by ``batch_shardings``, and the
same step runs on DTensors; rank 0 prints the summary line and writes the
checkpoints. The reference computes its parameter shardings and never
passes them to its ``jit`` (ROADMAP reference fault 9); the port applies
them. With no process group, ``--model-axis`` 1 is the one-device path
and any other value raises. Restore copies the checkpoint into the live
tensors; it fans nothing out with BBS (the reference's docstring says it
does, and its code does not: ROADMAP reference fault 8).
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import LM
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import steps
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.supervisor import TrainSupervisor


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-size)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-axis", type=int, default=1)
    args = ap.parse_args(argv)
    sharded = dist.is_initialized()
    if not sharded and args.model_axis != 1:
        raise ValueError(f"--model-axis {args.model_axis} needs a process "
                         f"group (torchrun); without one the port trains "
                         f"on one device")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if sharded and torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    model = LM(cfg, device=device, seed=0)
    step_fn = make_train_step(model, lr=args.lr,
                              microbatches=args.microbatches)
    data = SyntheticTokens(cfg, seq_len=args.seq, global_batch=args.batch)
    batch_fn = data.batch
    if sharded:
        mesh = make_host_mesh(args.model_axis,
                              device_type=torch.device(device).type)
        params = steps.place_params(
            model, steps.param_shardings(mesh, model,
                                         dict(model.named_parameters())))
        opt = steps.place(adamw_init(params),
                          steps.opt_shardings(mesh, model, params))
        bshard = steps.batch_shardings(mesh, cfg, data.batch(0))

        def batch_fn(step):
            return steps.place(data.batch(step), bshard)
    else:
        params = dict(model.named_parameters())
        opt = adamw_init(params)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    sup = TrainSupervisor(step_fn, batch_fn, ckpt,
                          ckpt_every=args.ckpt_every)
    t0 = time.time()
    state = sup.run(dict(params=params, opt=opt), start_step=0,
                    num_steps=args.steps)
    dt = time.time() - t0
    hist = state["history"]
    if not sharded or dist.get_rank() == 0:
        print(f"trained {args.steps} steps in {dt:.1f}s; "
              f"loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
              f"stragglers={sup.stats.stragglers} "
              f"retries={sup.stats.retries}")
    return state


if __name__ == "__main__":
    main()
