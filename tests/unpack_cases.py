"""The packet layouts that the tests of the runner's copy out
(``runner.unpack``) run on: ``tests/test_torch_unpack.py`` on the CPU (the
plain version and the kernel's numpy model) and ``tests/test_torch_cuda.py``
on the card (the kernel itself)."""

import torch

from repro_torch.device.runner import PacketLayout

# (dtype, n, total, relay, plen, numel): used = plen x element size covers
# used % 16 in {0, 4, 8, 12} and odd, a remainder or none, n = 1, a payload
# shorter than one row, chunks that span several devices and many warps'
# worth of segments
LAYOUTS = [
    ("float32", 5, 7, 0, 1000, 7 * 1000),
    ("float32", 5, 7, 0, 1001, 6 * 1001 + 500),
    ("float32", 3, 9, 2, 1002, 8 * 1002 + 1),
    ("float32", 4, 9, 0, 1003, 9 * 1003),
    ("float32", 1, 9, 0, 1001, 8 * 1001 + 7),
    ("float32", 8, 4, 0, 1001, 3),
    ("uint8", 6, 11, 0, 1001, 10 * 1001 + 3),
    ("uint8", 7, 5, 1, 777, 4 * 777 + 1),
    ("uint8", 9, 3, 0, 33, 5),
    ("uint8", 300, 40, 0, 4093, 39 * 4093 + 4091),
    ("bfloat16", 5, 6, 0, 501, 5 * 501 + 77),
    ("bfloat16", 1, 3, 0, 7, 5),
    ("float64", 3, 4, 0, 501, 3 * 501 + 250),
    ("float64", 2, 64, 0, 2048, 64 * 2048),
]

# (total, used, row_bytes, nbytes) of the benchmark cells' 16 shapes
# (runner.packet_layout on mesh2d-256's and dragonfly-256's plans, roots 0
# and 17, float32; dragonfly's two 4e6 B shapes share one layout)
REAL = [
    (378, 10584, 10592, 4000000), (754, 21224, 21232, 16000000),
    (1510, 42388, 42400, 64000000), (2134, 59984, 59984, 128000000),
    (451, 8872, 8880, 4000000), (902, 17740, 17744, 16000000),
    (1803, 35500, 35504, 64000000), (2550, 50200, 50208, 128000000),
    (130, 30772, 30784, 4000000), (1370, 11680, 11680, 16000000),
    (2740, 23360, 23360, 64000000), (3870, 33076, 33088, 128000000),
    (1388, 11528, 11536, 16000000), (2775, 23064, 23072, 64000000),
    (3925, 32612, 32624, 128000000),
]


def layout_id(case) -> str:
    return "-".join(str(v) for v in case[:2] + case[4:5])


def layout(dtype, n, total, relay, plen, numel):
    """A row of ``LAYOUTS`` as its ``PacketLayout`` and payload bytes."""
    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    used = plen * esize
    return PacketLayout(n=n, total=total, relay=relay, plen=plen, used=used,
                        row_bytes=-(-used // 16) * 16), numel * esize
