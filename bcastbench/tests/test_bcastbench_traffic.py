"""The traffic generators and payloads: deterministic by seed, and drawing
the roots and sizes their mixes state."""

import itertools
import json
from collections import Counter

import pytest
import torch

from conftest import ROOT

from bcastbench import manifest, traffic

MIXES = sorted(p.stem for p in (ROOT / "bcastbench" / "mixes").glob("*.json"))
SEEDS = [0, 7, 2 ** 31 + 12345, 2 ** 40 + 3, -5]


def _mix(mix_name):
    mix = json.loads((ROOT / "bcastbench" / "mixes" /
                      f"{mix_name}.json").read_text())
    return mix, manifest.load_module(ROOT / "bcastbench" / "generators" /
                                     f"{mix['generator']}.py")


def _stream(mix_name, seed, n, count):
    mix, gen = _mix(mix_name)
    return mix, list(itertools.islice(gen.stream(mix, seed, n, 4), count))


@pytest.mark.parametrize("mix_name", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_stream_is_deterministic_by_seed(mix_name, seed):
    _, a = _stream(mix_name, seed, 256, 600)
    _, b = _stream(mix_name, seed, 256, 600)
    _, c = _stream(mix_name, seed + 1, 256, 600)
    assert a == b
    assert [(r.root, r.nbytes) for r in a] != [(r.root, r.nbytes) for r in c]
    assert [r.index for r in a] == list(range(600))


@pytest.mark.parametrize("mix_name", MIXES)
def test_stream_draws_the_stated_roots_and_sizes(mix_name):
    n = 256
    mix, _ = _stream(mix_name, 11, n, 0)
    mix, reqs = _stream(mix_name, 11, n, 5 * n * len(mix["sizes"]))
    roots = set(range(n)) if mix["roots"] == "all" else set(mix["roots"])
    assert {r.root for r in reqs} == roots
    assert {r.nbytes for r in reqs} == set(mix["sizes"])


@pytest.mark.parametrize("mix_name", MIXES)
def test_every_block_sends_the_same_pairs(mix_name):
    """A seed changes the order, never the work: each block sends every
    (root, size) once, and ``block`` says how long a block is."""
    mix, gen = _mix(mix_name)
    roots = list(range(256)) if mix["roots"] == "all" else mix["roots"]
    pairs = Counter((r, s) for r in roots for s in mix["sizes"])
    block = gen.block(mix, 256, 4)
    assert block == len(pairs)
    for seed in (3, 2 ** 33):
        _, reqs = _stream(mix_name, seed, 256, block * 5)
        got = [(r.root, r.nbytes) for r in reqs]
        for b in range(0, len(got), block):
            assert Counter(got[b:b + block]) == pairs


def test_the_large_mix_is_the_papers():
    mix, _ = _mix("large")
    assert mix["roots"] == [0, 17]
    assert mix["sizes"] == [4_000_000, 16_000_000, 64_000_000, 128_000_000]


def test_window_keeps_and_check_slots():
    from bcastbench import harness
    shapes = [(r, s) for r in (0, 17) for s in (4, 16, 64)]
    assert harness.window_keeps(shapes, lambda s: 10 * s, 80) == \
        [(0, 4), (17, 4)]
    assert harness.window_keeps(shapes, lambda s: 10 * s, 0) == []
    slots = harness.check_slots(2 ** 31 + 9, shapes, 4)
    assert slots == harness.check_slots(2 ** 31 + 9, shapes, 4)
    assert set(slots) == set(shapes) and set(slots.values()) <= set(range(4))


def test_slots_take_each_payload_of_a_size_in_turn():
    mix, reqs = _stream("large", 5, 256, 200)
    for size in mix["sizes"]:
        slots = [r.slot for r in reqs if r.nbytes == size]
        assert slots == [i % mix["pool"] for i in range(len(slots))]


@pytest.mark.parametrize("seed", SEEDS)
def test_payload_is_seeded_bytes(seed):
    a = traffic.payload(seed, 4096, 1, torch.device("cpu"), torch.float32)
    assert a.dtype == torch.float32 and a.numel() * 4 == 4096
    assert torch.equal(a.view(torch.uint8), traffic.payload(
        seed, 4096, 1, torch.device("cpu"), torch.float32).view(torch.uint8))
    for other in (traffic.payload(seed, 4096, 2, "cpu", torch.float32),
                  traffic.payload(seed + 1, 4096, 1, "cpu", torch.float32)):
        assert not torch.equal(a.view(torch.uint8), other.view(torch.uint8))


def test_sizes_must_be_whole_elements():
    with pytest.raises(ValueError):
        traffic.sizes_of({"sizes": [4098]}, 4)
    with pytest.raises(ValueError):
        traffic.roots_of({"roots": [0, 16]}, 16)


def test_the_keeper_copies_first_answers_and_keeps_the_last():
    from bcastbench import harness
    from bcastbench.traffic import Request
    spare = {(0, 8): torch.empty(16, dtype=torch.uint8)}
    keeper = harness.Keeper([(0, 8)], spare)
    out = torch.arange(4, dtype=torch.float32).reshape(2, 2)
    keeper.offer(Request(0, 0, 8, 0), out)
    keeper.offer(Request(1, 0, 8, 1), out + 1)          # not the first
    keeper.offer(Request(2, 17, 8, 0), out + 2, last=True)
    (first, a), (last, b) = keeper.kept
    assert (first.index, last.index) == (0, 2) and not spare
    assert torch.equal(a, out) and a.data_ptr() != out.data_ptr()
    assert torch.equal(b, out + 2)
