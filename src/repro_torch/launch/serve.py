"""Batched serving: prompt fill + greedy decode loop.

    python -m repro_torch.launch.serve --arch mamba2-370m --smoke --tokens 32
    python -m repro_torch.launch.serve --arch llama3.2-3b --tokens 32

The port of ``repro.launch.serve``, for every ``--arch`` and with the same
flags and flow: the weights come from seed 0, the prompts from
``SyntheticTokens`` step 0; the cache is made with ``enc_len`` = the prompt
length, an encdec's ``cache["enc"]`` is the encoder's pass over the batch's
frames, the prompt is teacher-forced through ``decode_step`` (which fills
the cache), then decoding is greedy. As in the reference, a vlm's patches
are not fed: ``decode_step`` has no patch path, so a served vlm answers
from the text alone (ROADMAP queue 3, fault 7). It runs on cuda;
``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.model import LM


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor      # (B, new_tokens) int32, greedy
    fill_s: float             # teacher-forcing the prompt
    gen_s: float              # the greedy loop

    @property
    def tok_per_s(self) -> float:
        return self.tokens.numel() / self.gen_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def generate(model: LM, batch: Dict[str, torch.Tensor],
             new_tokens: int) -> Generation:
    """Teacher-force ``batch["tokens"]`` (B, P) through ``decode_step``,
    then take ``new_tokens`` greedy steps. An encdec attends to the
    encoder's pass over ``batch["frames"]``."""
    dev = model.device
    prompt = batch["tokens"].to(dev)
    b, plen = prompt.shape
    cache = model.init_cache(b, plen + new_tokens + 1, enc_len=plen)
    if model.cfg.family == "encdec":
        cache["enc"] = model._encoder(batch["frames"])
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(plen):
        logits, cache = model.decode_step(cache, prompt[:, t:t + 1])
    _sync(dev)
    fill_s = time.perf_counter() - t0
    out = []
    t0 = time.perf_counter()
    cur = _argmax(logits)
    for _ in range(new_tokens):
        out.append(cur)
        logits, cache = model.decode_step(cache, cur)
        cur = _argmax(logits)
    gen = torch.cat(out, dim=1)
    _sync(dev)
    return Generation(gen, fill_s, time.perf_counter() - t0)


def main(argv=None, device="cuda") -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="mamba2-370m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = LM(cfg, device=device, seed=0)
    data = SyntheticTokens(cfg, seq_len=args.prompt_len,
                           global_batch=args.batch)
    res = generate(model, data.batch(0), args.tokens)
    print(f"{cfg.name}: prompt {args.prompt_len} tok fill {res.fill_s:.2f}s; "
          f"generated {args.tokens}x{args.batch} tokens in {res.gen_s:.2f}s "
          f"({res.tok_per_s:.1f} tok/s); sample: "
          f"{res.tokens[0, :16].tolist()}")
    return res.tokens


if __name__ == "__main__":
    main()
