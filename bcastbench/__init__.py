"""The benchmark of ``repro_torch``: BBS broadcasts on one H100 or across a
group of H100s, driven by the cells of ``BENCHMARK.json``.

One run is one cell, once::

    python3 bcastbench/run.py --workload mesh2d-256.large --seed 7 \
        --seconds 10 --trace 0

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``mixes/<traffic>.json`` (read by
``generators/<generator>.py``) and ``metrics/<metric>.py``. Nothing here
imports JAX or the JAX package ``repro``; ``reference.py`` imports nothing
of ``repro_torch`` either.
"""
