"""End-to-end training on one device.

    python -m repro_torch.launch.train --arch llama3.2-3b --smoke --steps 100

The port of ``repro.launch.train``, with its flags and summary line: the
model (smoke or full config) with weights from seed 0, AdamW
(``optim.adamw``), ``SyntheticTokens`` batches keyed by step, and the
fault-tolerant supervisor loop (checkpoint/restart, retries, straggler
stats) around ``runtime.steps.make_train_step``. It runs on cuda;
``main(argv, device="cpu")`` runs it on the CPU. ``--model-axis`` other
than 1 raises: tensor parallelism waits for the sharding slice (ROADMAP
queue 1 item 3). Restore copies the checkpoint into the live tensors; it
fans nothing out with BBS (the reference's docstring says it does, and its
code does not: ROADMAP reference fault 8).
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.model import LM
from repro_torch.optim.adamw import adamw_init
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
    if args.model_axis != 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis}: the port trains on one device; "
            f"tensor parallelism waits for the sharding slice (ROADMAP queue "
            f"1 item 3)")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = LM(cfg, device=device, seed=0)
    step_fn = make_train_step(model, lr=args.lr,
                              microbatches=args.microbatches)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    data = SyntheticTokens(cfg, seq_len=args.seq, global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    sup = TrainSupervisor(step_fn, data.batch, ckpt,
                          ckpt_every=args.ckpt_every)
    t0 = time.time()
    state = sup.run(dict(params=params, opt=opt), start_step=0,
                    num_steps=args.steps)
    dt = time.time() - t0
    hist = state["history"]
    print(f"trained {args.steps} steps in {dt:.1f}s; "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
          f"stragglers={sup.stats.stragglers} retries={sup.stats.retries}")
    return state


if __name__ == "__main__":
    main()
