"""Do relay rows cost K1 more a byte than packet rows?

    python3 tools/relay_cost.py [--n 256] [--sizes 4e6,16e6,64e6,128e6] \\
        [--reps 7] [--device cuda]

On the flattened butterfly's BBS plans from root 0
(``core.topology.butterfly(n)``, two trees whose multi-hop edges run
through relay rows) it times K1 (``round_step.permute_rounds``) over
three sets of moves of one plan, in turns:

* ``all``: every move of the plan;
* ``no_relay``: all but the moves that read or write a relay row;
* ``no_other``: all but as many other moves in each sub-round, drawn at
  random (a fixed seed); a sub-round with fewer other moves than relay
  moves loses all its other moves. So the per-byte readings below, not
  the times, compare the two.

The first rep of each set is left out and the median of the rest kept
(CUDA events on a GPU, the host clock on the CPU). Each size prints one
JSON line: the sets' moves and HBM bytes (a row written a move, a row
read a move that is no zero write), the steps K1 runs each in (on a
GPU its dependency phases, each set's own), their median µs, and the
picoseconds a byte that dropping the relay moves and dropping the others
saved (``relay_ps_per_byte``, ``other_ps_per_byte``) beside the whole
plan's (``all_ps_per_byte``). The buffer's contents are not checked: a set of
moves with some dropped delivers a wrong payload.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.simconfig import DeviceConfig, SimConfig  # noqa: E402
from repro_torch.device import round_step as rs  # noqa: E402
from repro_torch.device import runner  # noqa: E402


ROOT_NODE = 0
SEED = 28


def relay_mask(pairs: torch.Tensor, rows: int, packets: int) -> np.ndarray:
    """The pairs that write a relay row or read one live (rows
    ``[packets, rows)`` of each device's ``rows``)."""
    dst, src = pairs.cpu().numpy().T
    return (dst % rows >= packets) | ((src >= 0) & (src % rows >= packets))


def keep(moves: rs.Moves, mask: np.ndarray, packets: int,
         row_bytes: int) -> rs.Moves:
    """``moves`` with only the pairs in ``mask``, in the same sub-rounds,
    with their prefix sums, and their phases if they had any (sized for
    rows of ``row_bytes``), counted again."""
    s = moves.num_subrounds
    sub = np.repeat(np.arange(s), moves.counts)[mask]
    pairs = moves.pairs.cpu()[torch.from_numpy(mask)].contiguous()
    zero = pairs[:, 1].numpy() < 0
    relay = relay_mask(pairs, moves.rows, packets)

    def prefix(sel):
        per = np.bincount(sub[sel], minlength=s)
        return np.concatenate([[0], np.cumsum(per)]).astype(np.int64)

    every = np.ones(len(sub), bool)
    counts = np.bincount(sub, minlength=s).astype(np.int64)
    kept = dataclasses.replace(
        moves, pairs=pairs.to(moves.device),
        offs=torch.from_numpy(prefix(every)).to(moves.device), counts=counts,
        moves_cum=prefix(every), zeros_cum=prefix(zero),
        relay_cum=prefix(relay), relay_zeros_cum=prefix(relay & zero),
        phases=None)
    return kept if moves.phases is None else rs.with_phases(kept, row_bytes)


def variants(moves: rs.Moves, packets: int, rng: np.random.Generator,
             row_bytes: int) -> Dict[str, rs.Moves]:
    """The three sets of moves: ``all``, ``no_relay``, ``no_other``."""
    relay = relay_mask(moves.pairs, moves.rows, packets)
    other = np.ones(len(relay), bool)
    for s in range(moves.num_subrounds):
        lo, hi = moves.moves_cum[s], moves.moves_cum[s + 1]
        k = int(relay[lo:hi].sum())
        cand = np.flatnonzero(~relay[lo:hi]) + lo
        other[rng.choice(cand, size=min(k, len(cand)), replace=False)] = False
    return {"all": moves,
            "no_relay": keep(moves, ~relay, packets, row_bytes),
            "no_other": keep(moves, other, packets, row_bytes)}


def _timed_us(buf: torch.Tensor, moves: rs.Moves) -> float:
    if buf.is_cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        rs.permute_rounds(buf, moves)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3
    t0 = time.perf_counter()
    rs.permute_rounds(buf, moves)
    return (time.perf_counter() - t0) * 1e6


def measure(model, nbytes: float, dev: torch.device, reps: int,
            rng: np.random.Generator) -> dict:
    """One size's line: the three sets timed in turns, forward and back."""
    ex = model.executable(ROOT_NODE, nbytes, config=SimConfig(
        device=DeviceConfig(device=dev.type)))
    x = torch.zeros(int(nbytes) // 4)
    lay = runner.packet_layout(x, ex.schedule, ex.num_groups)
    row = lay.row_bytes
    moves = runner.build_moves(ex.schedule, ex.num_groups, x, dev)
    sets = variants(moves, lay.total, rng, row)
    nb = {k: m.moved_bytes(0, m.num_subrounds, row) for k, m in sets.items()}
    buf = runner.pack(x.to(dev), lay, ROOT_NODE, dev)
    got: Dict[str, List[float]] = {k: [] for k in sets}
    for r in range(reps):
        for k in (list(sets) if r % 2 == 0 else list(sets)[::-1]):
            got[k].append(_timed_us(buf, sets[k]))
    med = {k: float(np.median(v[1:])) for k, v in got.items()}
    del buf
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def ps_per_byte(drop):
        saved = nb["all"] - nb[drop]
        return 1e6 * (med["all"] - med[drop]) / saved if saved else None

    return {"root": ROOT_NODE, "nbytes": nbytes, "candidate": ex.candidate,
            "subrounds": moves.num_subrounds, "row_bytes": row,
            "relay_rows": lay.relay,
            "moves": {k: int(m.moves_cum[-1]) for k, m in sets.items()},
            "phases": {k: m.phases.count if m.phases else m.num_subrounds
                       for k, m in sets.items()},
            "bytes": nb, "us_median": med, "us_all_reps": got,
            "relay_ps_per_byte": ps_per_byte("no_relay"),
            "other_ps_per_byte": ps_per_byte("no_other"),
            "all_ps_per_byte": 1e6 * med["all"] / nb["all"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--sizes", default="4e6,16e6,64e6,128e6")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.reps < 2:
        ap.error("--reps must be at least 2: the first rep is left out")
    dev = torch.device(a.device)
    model = api.compile(topology.butterfly(a.n))
    rng = np.random.default_rng(SEED)
    for nbytes in (float(s) for s in a.sizes.split(",")):
        print(json.dumps(measure(model, nbytes, dev, a.reps, rng)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
