"""Tensor parallelism over the mesh's `model` dimension.

The PyTorch counterpart of `fiber_tpu/parallel/tp.py`.  Its rule, letter
for letter, applied to each parameter through the flax path and the flax
shape it has in the JAX package (`utils/convert.py::flax_path`): a leaf of
at least `_MIN_SHARD_SIZE` elements is split over the model ranks when it
is a `kernel` whose last (output) dimension divides by M, or an
`embedding` whose rows divide by M; every other leaf, biases among them,
stays whole on every rank.  A flax Dense kernel (in, out) is the torch
Linear weight (out, in), so JAX's columns are the weight's rows here: in
the port every sharded leaf is split along its dimension 0.

There XLA inserts the collectives of the sharded program; here
`shard_params_tp` swaps each sharded `nn.Linear` for a `ColumnLinear` and
each sharded `nn.Embedding` for a `RowEmbedding` holding this rank's slice
under the same state_dict name, and these compute what one process
computes:

* `ColumnLinear`: this rank's output columns, gathered over the model
  ranks (list-form all-gather) and concatenated, then the whole bias; every
  rank holds the whole activation, so the next op sees the shape it sees in
  one process.  Backward: the weight's gradient stays local, the input's
  partial gradient is summed over the model ranks.
* `RowEmbedding`: each rank looks up the ids that fall in its rows, zeros
  elsewhere, and the ranks' results are summed; one term of each sum is
  non-zero, so the sum is exact.  Backward: local.

The model ranks then run the same replicated computation on the same
rows, and every replicated parameter's gradient is the same on each.
Only list-form `all_gather` and `all_reduce` are used, which gloo and NCCL
both offer (under gloo a CUDA tensor goes through the host).

`full_state_dict` gathers a sharded model's state into one process's keys
and shapes, `load_sharded_state_dict` slices one process's state into a
sharded model; both are collectives of the model group.  `COLLECTIVES`
counts the forward's and backward's collectives and their bytes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fiber_torch.parallel.data_parallel import (all_gather_rows,
                                                all_reduce_sum_)
from fiber_torch.parallel.mesh import MODEL_AXIS, model_group

# parameters worth sharding: big matmul kernels and embeddings
_MIN_SHARD_SIZE = 1 << 16  # don't bother below 64K elements

# the model group's collectives in the sharded modules' forward and
# backward: their count and the bytes of the tensors they produce
COLLECTIVES = {"all_gather": 0, "all_gather_bytes": 0, "all_reduce": 0,
               "all_reduce_bytes": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES[kind + "_bytes"] += t.numel() * t.element_size()


# --------------------------------------------------------------------------
# The rule
# --------------------------------------------------------------------------
def _flax_shape(shape: Sequence[int], leaf: str) -> tuple:
    """A port parameter's shape as flax holds its `leaf`: a Linear weight
    (out, in) is the kernel (in, out), a conv's OIHW its HWIO; the rest as
    is."""
    shape = tuple(shape)
    if leaf != "kernel":
        return shape
    if len(shape) == 2:
        return shape[::-1]
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


def _whole_shapes(model: nn.Module) -> Dict[str, tuple]:
    """{parameter name: its whole shape}, a sharded weight's too."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for prefix, m in sharded_modules(model).items():
        shapes[prefix + "weight"] = m.full_shape
    return shapes


def tp_sharding(model: nn.Module, mesh) -> Dict[str, int]:
    """JAX's `tp_sharding` over the model's parameters (their whole shapes
    on a model already sharded): {name: the torch dimension it splits over
    the mesh's model ranks} (0: a 2-d or 4-d kernel's output dimension is
    the torch weight's first).  `mesh` may be the model dimension's
    size."""
    from fiber_torch.utils.convert import flax_path
    n_model = mesh if isinstance(mesh, int) else mesh.size(
        mesh.mesh_dim_names.index(MODEL_AXIS))
    out: Dict[str, int] = {}
    if n_model == 1:
        return out
    for name, shape in _whole_shapes(model).items():
        if int(np.prod(shape)) < _MIN_SHARD_SIZE:
            continue
        leaf = flax_path(name).rsplit("/", 1)[-1]
        fshape = _flax_shape(shape, leaf)
        if leaf == "kernel" and len(fshape) >= 2 \
                and fshape[-1] % n_model == 0:
            out[name] = 0 if len(fshape) in (2, 4) else len(fshape) - 1
        elif leaf == "embedding" and fshape[0] % n_model == 0:
            out[name] = 0
    return out


# --------------------------------------------------------------------------
# Collectives with gradients
# --------------------------------------------------------------------------
class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    ranks (each holds the part its columns give)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _count("all_reduce", grad)
        return all_reduce_sum_(grad, ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """Every model rank's columns concatenated on the last dimension, in
    rank order; the backward keeps this rank's columns of the gradient
    (the same whole gradient on every rank)."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.cols = group, y.shape[-1]
        out = all_gather_rows(y, group, dim=-1)
        _count("all_gather", out)
        return out

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad[..., r * ctx.cols:(r + 1) * ctx.cols], None


class _SumOverModel(torch.autograd.Function):
    """The sum over the model ranks forward; identity backward (the sum's
    gradient reaches every term whole)."""

    @staticmethod
    def forward(ctx, x, group):
        out = all_reduce_sum_(x.contiguous().clone(), group)
        _count("all_reduce", out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# --------------------------------------------------------------------------
# The sharded modules
# --------------------------------------------------------------------------
class _RowSharded(nn.Module):
    """A module whose `weight` is this model rank's block of rows of the
    whole weight."""

    def __init__(self, weight: torch.Tensor, group):
        super().__init__()
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.full_shape = tuple(weight.shape)
        self.rows = self.full_shape[0] // self.world
        self.weight = nn.Parameter(self.local(weight.detach()).clone())

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor shaped like the whole weight."""
        return full[self.rank * self.rows:(self.rank + 1) * self.rows]

    @torch.no_grad()
    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's rows (a tensor shaped like
        this rank's weight: the weight, its gradient, a moment)."""
        return all_gather_rows(shard, self.group)

    def full_weight(self) -> torch.Tensor:
        return self.gather(self.weight)


class ColumnLinear(_RowSharded):
    """nn.Linear with this rank's output columns (the weight's rows); the
    output is the whole activation (see the module's docstring)."""

    def __init__(self, linear: nn.Linear, group):
        super().__init__(linear.weight, group)
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.bias = linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_SumGradOverModel.apply(x, self.group), self.weight)
        y = _GatherColumns.apply(y, self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class RowEmbedding(_RowSharded):
    """nn.Embedding with this rank's rows of the table."""

    def __init__(self, emb: nn.Embedding, group):
        if (emb.padding_idx, emb.max_norm, emb.sparse) != (None, None, False):
            raise ValueError("RowEmbedding takes a plain nn.Embedding")
        super().__init__(emb.weight, group)
        self.num_embeddings, self.embedding_dim = emb.weight.shape

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.rank * self.rows
        own = (local >= 0) & (local < self.rows)
        e = F.embedding(local.clamp(0, self.rows - 1), self.weight)
        e = torch.where(own[..., None], e, torch.zeros_like(e))
        return _SumOverModel.apply(e, self.group)


_SHARDED_TYPES = {nn.Linear: ColumnLinear, nn.Embedding: RowEmbedding}


def shard_params_tp(model: nn.Module, mesh) -> Dict[str, int]:
    """Split `model`'s parameters over the mesh's model ranks by JAX's
    rule, in place: each sharded nn.Linear / nn.Embedding becomes a
    `ColumnLinear` / `RowEmbedding` of this rank's slice under the same
    name.  A leaf the rule shards in any other module raises, named.
    Returns `tp_sharding`'s map; {} when the model dimension is 1."""
    group = model_group(mesh)
    if group is None:
        return {}
    plan = tp_sharding(model, mesh)
    modules = dict(model.named_modules())
    for name in plan:
        owner, _, leaf = name.rpartition(".")
        m = modules[owner]
        if leaf != "weight" or type(m) not in _SHARDED_TYPES:
            raise ValueError(
                f"tensor parallelism: the rule shards {name!r}, a "
                f"{type(m).__name__} parameter; only nn.Linear and "
                f"nn.Embedding weights can be split")
    for name in plan:
        owner = name.rpartition(".")[0]
        parent, _, attr = owner.rpartition(".")
        m = modules[owner]
        setattr(modules[parent], attr, _SHARDED_TYPES[type(m)](m, group))
    return plan


def sharded_modules(model: nn.Module) -> Dict[str, _RowSharded]:
    """{module prefix with its trailing dot: sharded module}."""
    return {(n + "." if n else ""): m for n, m in model.named_modules()
            if isinstance(m, _RowSharded)}


def full_param(module: nn.Module, name: str) -> torch.Tensor:
    """`module.<name>` whole: gathered from the model ranks when it is a
    sharded weight (a collective), else the parameter itself."""
    if isinstance(module, _RowSharded) and name == "weight":
        return module.full_weight()
    return getattr(module, name)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every shard gathered: one process's keys
    and shapes (every model rank calls it)."""
    sd = model.state_dict()
    for prefix, m in sharded_modules(model).items():
        sd[prefix + "weight"] = m.full_weight()
    return sd


def load_sharded_state_dict(model: nn.Module,
                            state: Mapping[str, torch.Tensor],
                            strict: bool = True):
    """Load one process's state_dict into a sharded (or whole) model, each
    sharded weight sliced to this rank's rows."""
    state = dict(state)
    for prefix, m in sharded_modules(model).items():
        key = prefix + "weight"
        if key in state:
            if tuple(state[key].shape) != m.full_shape:
                raise ValueError(f"{key}: shape {tuple(state[key].shape)}, "
                                 f"expected {m.full_shape}")
            state[key] = m.local(state[key])
    return model.load_state_dict(state, strict=strict)


def param_shards(model: nn.Module) -> Dict[int, _RowSharded]:
    """{id of a sharded parameter: its module}, for the tensors shaped
    like a parameter (gradients, moments, EMA copies)."""
    return {id(m.weight): m for m in sharded_modules(model).values()}


def local_numel(model: nn.Module, plan: Optional[Mapping[str, int]] = None,
                n_model: int = 1) -> int:
    """The parameter elements one rank holds when `plan` shards over
    `n_model` ranks (the model's whole shapes)."""
    plan = plan or {}
    return sum(int(np.prod(s)) // (n_model if n in plan else 1)
               for n, s in _whole_shapes(model).items())
