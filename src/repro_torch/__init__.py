"""PyTorch / CUDA port of the BBS broadcast stack (``repro`` is the JAX
reference). Imports ``torch``, numpy and scipy; never ``jax`` or ``repro``.

``repro_torch.core`` is the port's own copy of the numpy host layer
(topology, LP, trees, schedule, simulators, BBS plans, baselines);
``repro_torch.device`` runs plans on n virtual devices of one GPU, one
hand-written CUDA kernel launch per sub-round; ``repro_torch.api`` is the
facade.
"""
