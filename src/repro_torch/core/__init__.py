"""BBS core: the paper's contribution (topology, LP, trees, schedule, sim).

The port's own copy of the framework-neutral numpy layer of ``repro.core``
(the port imports nothing of the JAX package), the PlanStore included. The
jitted event core (``repro.core.kernelsim``) is not part of it yet."""

from repro_torch.core import arborescence, baselines, bbs, coloring, \
    fastsim, faults, intersection, lp, planstore, routing, schedule, \
    simconfig, simulator, symmetry, timeprofile, topology  # noqa: F401
