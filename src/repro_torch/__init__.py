"""PyTorch / CUDA port of the BBS broadcast stack (``repro`` is the JAX
reference). Imports ``torch``, numpy and scipy; never ``jax`` or ``repro``.

``repro_torch.core`` is the port's own copy of the numpy host layer
(topology, LP, trees, schedule, simulators, BBS plans, baselines);
``repro_torch.device`` runs plans on n virtual devices of one GPU, every
sub-round of a broadcast in one launch of a hand-written CUDA kernel, and
calibrates the simulator's Hockney constants from it;
``repro_torch.core.planstore``, ``repro_torch.launch.planserver`` and
``repro_torch.workload`` are copies of the reference's plan store, plan
server and workload engine; ``repro_torch.api`` is the facade. The LM
substrate so far: ``configs`` (a copy), ``data``, ``kernels`` (flash
attention and the SSD scan as hand-written CUDA kernels beside their plain
versions), ``models`` (the ``ssm`` and ``dense`` families) and
``launch.serve``.
"""
