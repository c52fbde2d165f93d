"""The collectives of data-parallel training.

The JAX package needs none of this: its train step is one global-view
program over the mesh, and XLA inserts the collectives.  Here each rank
holds B / R rows of the global batch and the losses are written so that
the sum over ranks of each rank's partial loss is the global-batch loss:

* every normalizer is global: a rank divides its local sum by the count
  over all ranks (`global_count`; counts carry no gradient);
* the ITC columns and the hard negatives read the batch of every rank
  (`all_gather_rows`, no gradient: JAX stops it there too); the shallow
  contrastive loss, whose logits span the whole batch with gradient on
  both sides, gathers with `all_gather_rows_grad`;
* after backward the gradients are summed once over one flat buffer of
  which every `.grad` is a view (`flat_grads`, `all_reduce_grads_`), and
  the step's metrics once as one stacked vector (`all_reduce_metrics`).

Then the summed gradient is the global loss's gradient, which a mean of
per-rank means (DDP's AVG) is not as soon as two ranks count differently.

Only collectives that gloo and NCCL both offer are used: list-form
`all_gather`, `all_reduce`, `broadcast`.  Under gloo a CUDA tensor goes
through the host (two ranks sharing one card run gloo).  `group` None
means one process: every helper is then the identity and makes no
`torch.distributed` call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


def rank_world(group) -> Tuple[int, int]:
    """(this rank, the group's size); (0, 1) with no group."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _staged(group, x: torch.Tensor) -> bool:
    """gloo takes the tensor from the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A copy of the CUDA tensor `x` in pinned host memory, where gloo
    reads it (the copies to and from the card run at pinned rates)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the group's ranks, in place; returns `x`."""
    if group is None:
        return x
    if _staged(group, x):
        h = _to_host(x)
        dist.all_reduce(h, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=group)
    return x


def global_count(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of a count (or any tensor without gradient), a
    new tensor; `x` itself with no group."""
    if group is None:
        return x
    return all_reduce_sum_(x.detach().clone(), group)


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (the same shape on each) concatenated in rank order
    along `dim` (the leading axis by default), without gradient; `x` with
    no group."""
    if group is None:
        return x
    world = dist.get_world_size(group)
    src = x.detach().contiguous()
    staged = _staged(group, src)
    if staged:
        src = _to_host(src)
    parts = [torch.empty(src.shape, dtype=src.dtype, device=src.device,
                         pin_memory=staged) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    if staged:
        # this rank's part is on the card already
        rank = dist.get_rank(group)
        parts = [x.detach() if r == rank else p.to(x.device)
                 for r, p in enumerate(parts)]
    return torch.cat(parts, dim=dim)


class _GatherRows(torch.autograd.Function):
    """`all_gather_rows` whose backward sums the gathered gradient over the
    ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_sum_(grad.contiguous().clone(), ctx.group)
        rank = dist.get_rank(ctx.group)
        return grad[rank * ctx.rows:(rank + 1) * ctx.rows], None


def all_gather_rows_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` concatenated in rank order, with gradient: a loss
    each rank computes on the gathered rows, summed over the ranks, reaches
    each rank's own rows through the backward's all-reduce."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


def flat_grads(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """One zeroed fp32 buffer on the parameters' device of which every
    parameter's `.grad` becomes a view; autograd accumulates into it in
    place, so one all-reduce covers every gradient."""
    total = sum(p.numel() for p in params)
    flat = torch.zeros(total, dtype=params[0].dtype, device=params[0].device)
    off = 0
    for p in params:
        if p.dtype != flat.dtype or p.device != flat.device:
            raise ValueError("flat_grads: the parameters differ in dtype or "
                             "device")
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return flat


def all_reduce_grads_(flat: torch.Tensor, group) -> None:
    """Sum the flat gradient buffer over the ranks, in place."""
    all_reduce_sum_(flat, group)


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], group
                       ) -> Dict[str, torch.Tensor]:
    """The step's 0-dim metrics summed over the ranks, in one collective of
    their stacked vector; the metrics as they are with no group."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_sum_(vec, group)
    return dict(zip(keys, vec.unbind()))


def all_gather_objects(obj: Any, group) -> List[Any]:
    """Every rank's picklable `obj`, in rank order; [obj] with no
    group."""
    if group is None:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


@torch.no_grad()
def broadcast_(tensors: List[torch.Tensor], group, src: int = 0) -> None:
    """Rank `src`'s values of `tensors` (one dtype and device) on every
    rank, in place, through one flat buffer."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    staged = _staged(group, flat)
    buf = _to_host(flat) if staged else flat
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    if staged:
        flat.copy_(buf)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
