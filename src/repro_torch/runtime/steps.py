"""train_step / serve_step builders with explicit shardings, the port of
``repro.runtime.steps``.

``make_train_step(model, lr, microbatches)`` returns ``train_step(params,
opt, batch) -> (params, opt, metrics)``, the reference's contract, with
``metrics = dict(loss, grad_norm)`` (0-d float32 tensors). ``params`` is
the model's own name -> parameter dict (``dict(model.named_parameters())``):
the loss is ``model.loss(batch)`` on those tensors, and AdamW updates them
in place (``optim.adamw``), so the same dict is returned. With
``microbatches > 1`` the batch is split on dim 0 and each part's gradients
are summed into float32 zeros, as the reference's ``lax.scan`` does; loss
and gradients are then divided by the count. ``grad_norm`` is the global
norm of the gradients before the clip, as in the reference.

On a mesh the same step runs with ``params``, ``opt`` and ``batch`` as
DTensors, placed by the helpers below (``place_params``, ``place``): each
gradient is redistributed to its parameter's placements (a reduce-scatter
where the backward left it partial), so AdamW's global-norm clip and
``grad_norm`` reduce over the mesh, and the metrics come back whole.

The sharding helpers are the reference's: ``param_shardings``,
``batch_shardings``, ``cache_shardings`` (with the ``long_seq`` rewrite
for batch-1 cells) and ``opt_shardings`` (``mu`` and ``nu`` like the
params, ``step`` replicated) map the logical dims through
``runtime.sharding`` to ``(mesh, placements)``. ``abstract_params``,
``abstract_opt`` and ``abstract_cache`` give shapes and dtypes with no
allocation, the counterpart of ``jax.eval_shape``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import batch_logical_dims
from repro_torch.models.model import LM
from repro_torch.optim.adamw import adamw_update, global_norm
from repro_torch.runtime import sharding as shd


def value_and_grad(model: LM, params: Mapping[str, torch.Tensor],
                   batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """``(loss, grads)`` of ``model.loss(batch)``; a parameter the loss does
    not reach gets zeros, as ``jax.grad`` gives."""
    first = next(iter(params.values()))
    with shd.implicit_replication(first):
        loss = model.loss(batch)
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else _like(g, p)
             for (k, p), g in zip(params.items(), got)}
    return loss.detach(), grads


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model: LM, lr: float = 3e-4, microbatches: int = 1):
    """(params, opt, batch) -> (params, opt, metrics) (module docstring).
    Turns the model's gradients on (``LM`` builds its parameters frozen)."""
    model.requires_grad_(True)

    def train_step(params, opt, batch):
        own = dict(model.named_parameters())
        if params.keys() != own.keys() or \
                any(params[k] is not p for k, p in own.items()):
            raise ValueError("params must be the model's own parameters, "
                             "dict(model.named_parameters())")
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            m = b // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(microbatches):
                part = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                l, g = value_and_grad(model, params, part)
                loss += l
                for k, acc in grads.items():
                    acc += g[k]
                del g
            loss = loss / microbatches
            for acc in grads.values():
                acc.div_(microbatches)
        with shd.implicit_replication(next(iter(params.values()))):
            params, opt = adamw_update(params, grads, opt, lr=lr)
            gnorm = global_norm(grads)
        return params, opt, dict(loss=_whole(loss), grad_norm=_whole(gnorm))

    return train_step


def make_serve_prefill(model: LM):
    def prefill(batch):
        return model.forward(batch)

    return prefill


def make_serve_step(model: LM):
    def serve_step(cache, tokens):
        return model.decode_step(cache, tokens)

    return serve_step


# ------------------------------------------------------------ shardings

def param_shardings(mesh, model: LM, params_shape: Mapping) -> Dict:
    """``(mesh, placements)`` of each parameter, by state-dict name;
    ``params_shape`` holds tensors or ``(shape, dtype)`` stand-ins."""
    specs = shd.tree_specs(mesh, model.param_dims(), params_shape)
    return shd.shardings(mesh, specs)


def batch_shardings(mesh, cfg: ModelConfig, batch_shape: Mapping) -> Dict:
    dims = {k: v for k, v in batch_logical_dims(cfg).items()
            if k in batch_shape}
    return shd.shardings(mesh, shd.tree_specs(mesh, dims, batch_shape))


def cache_shardings(mesh, model: LM, cache_shape: Mapping,
                    long_ctx: bool) -> Dict:
    dims = dict(model.cache_dims())
    if long_ctx:
        # batch=1 cells: shard the cache sequence across everything we have
        dims = {k: tuple("long_seq" if d == "kv_seq" else d for d in v)
                for k, v in dims.items()}
    dims = {k: v for k, v in dims.items() if k in cache_shape}
    return shd.shardings(mesh, shd.tree_specs(mesh, dims, cache_shape))


def opt_shardings(mesh, model: LM, params_shape: Mapping) -> Dict:
    pshard = param_shardings(mesh, model, params_shape)
    return dict(mu=pshard, nu=pshard,
                step=(mesh, shd.placements(mesh, ())))


# ------------------------------------------------------- abstract state

def abstract_params(model: LM) -> Dict:
    """``(shape, dtype)`` of every parameter, by state-dict name."""
    return {k: (tuple(p.shape), p.dtype)
            for k, p in model.named_parameters()}


def abstract_opt(params_shape: Mapping) -> Dict:
    """AdamW's state as ``(shape, dtype)``: float32 moments, int32 step."""
    moments = {k: (shd.shape_of(v), torch.float32)
               for k, v in params_shape.items()}
    return dict(mu=moments, nu=dict(moments), step=((), torch.int32))


def abstract_cache(model: LM, batch: int, max_seq: int,
                   enc_len: int = 0) -> Dict:
    meta = LM(model.cfg, device="meta", seed=None)
    return {k: (tuple(v.shape), v.dtype) for k, v in
            meta.init_cache(batch, max_seq, enc_len=enc_len).items()}


# ------------------------------------------------------------- placing

def place(tree: Mapping, shardings: Mapping, abstract: bool = False) -> Dict:
    """Every tensor of a (nested) dict as a DTensor with its ``(mesh,
    placements)``: the whole tensor (a DTensor is gathered first) is
    distributed from rank 0's copy, as the reference re-places an array
    with ``device_put(np.asarray(x), sharding)``. With ``abstract`` the
    leaves need only a shape and dtype (tensors or ``(shape, dtype)``), and
    each rank's shard is an empty tensor on the mesh's device, a fake one
    under ``FakeTensorMode``: the dry-run's state, which moves nothing."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = place(v, shardings[k], abstract)
            continue
        mesh, pls = shardings[k]
        if isinstance(v, DTensor) and v.device_mesh == mesh and \
                tuple(v.placements) == tuple(pls):
            out[k] = v               # already placed so
            continue
        if abstract:
            out[k] = _empty_shard(v, mesh, pls)
            continue
        full = _whole(v).detach().to(mesh.device_type).contiguous()
        out[k] = distribute_tensor(full, mesh, pls)
    return out


def _empty_shard(leaf, mesh, pls) -> DTensor:
    """A DTensor of ``leaf``'s shape and dtype whose local shard is empty;
    the rules split only dims that divide evenly."""
    from torch.distributed.tensor import Shard

    shape = shd.shape_of(leaf)
    dtype = leaf.dtype if hasattr(leaf, "dtype") else leaf[1]
    local = list(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    t = torch.empty(local, dtype=dtype, device=mesh.device_type)
    return DTensor.from_local(t, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def place_params(model: nn.Module, shardings: Mapping,
                 abstract: bool = False) -> Dict:
    """Replace each parameter of ``model`` by a DTensor parameter placed by
    ``shardings`` (``param_shardings``; ``abstract`` as in ``place``),
    keeping its ``requires_grad``; returns
    ``dict(model.named_parameters())``."""
    placed = place(dict(model.named_parameters()), shardings, abstract)
    for name, p in list(model.named_parameters()):
        mod, attr = name.rsplit(".", 1)
        model.get_submodule(mod)[attr] = nn.Parameter(
            placed[name], requires_grad=p.requires_grad)
    return dict(model.named_parameters())
