"""The control of the comparison that decides ``correct``, at a cell's own
sizes: the reference put in the program's place in the precision below the
configurations' float32 (``reference.control_copies``: every node's copy
rounded to bfloat16), judged as a run judges the program's copies.

    python3 bcastbench/control.py --workload mesh2d-256.large \
        --seeds 11,12,13

For each seed it takes the answers a run compares (``virtual.run``): the
window's first answer of each shape that ``harness.window_keeps`` keeps,
and one check request of every shape (``harness.check_slots``); the
window's last answer, which depends on the window's length, is left out.
It prints the bytes by which the control's copies differ from the
reference, per seed and the least over the seeds: the upper reading of the
limit, whose lower reading (0) the program's runs give. The benchmark's own
runs do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent)]


def compared(cell, seed: int, n: int, esize: int) -> list:
    """``(nbytes, slot)`` of each answer a run of ``cell`` compares, but
    the window's last."""
    from bcastbench import harness

    mix, gen = cell.mix, cell.generator()
    shapes = gen.shapes(mix, n, esize)
    todo = set(harness.window_keeps(shapes, lambda nb: n * nb,
                                    float(mix["keep_bytes"])))
    out = []
    for req in gen.stream(mix, seed, n, esize):
        if not todo:
            break
        if (req.root, req.nbytes) in todo:
            todo.discard((req.root, req.nbytes))
            out.append((req.nbytes, req.slot))
    slots = harness.check_slots(seed, shapes, int(mix["pool"]))
    return out + [(shape[1], slots[shape]) for shape in shapes]


def control_bad_bytes(cell, seed: int, device) -> dict:
    """The control's differing bytes over the answers a run compares, and
    how many it compared."""
    import torch

    from bcastbench import reference

    dtype = getattr(torch, cell.config["payload_dtype"])
    esize = torch.empty((), dtype=dtype).element_size()
    n = int(cell.config["nodes"])
    answers = compared(cell, seed, n, esize)
    bad = 0
    for nbytes, slot in answers:
        want = reference.expected_copy(seed, nbytes, slot, device, dtype)
        bad += reference.bad_bytes(reference.control_copies(want, n), want, n)
    return {"seed": seed, "bad_bytes": bad, "answers": len(answers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from bcastbench import manifest

    cell = manifest.find_cell(args.workload, root=HERE.parent)
    dev = torch.device("cuda")
    rows = [control_bad_bytes(cell, int(s), dev)
            for s in args.seeds.split(",")]
    for r in rows:
        print(f"[control] {cell.name} seed {r['seed']}: {r['bad_bytes']} "
              f"bytes differ over {r['answers']} answers", file=sys.stderr)
    print(json.dumps({"workload": cell.name, "rows": rows,
                      "least": min(r["bad_bytes"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
