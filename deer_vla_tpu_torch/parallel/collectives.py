"""The collectives of weight placement, over one ``mesh.AxisGroup``.

Tensor parallel (Megatron's pair): ``copy_to_tp`` marks the input of a
column-parallel product (identity forward, all-reduce backward: each rank's
gradient of the replicated input is a partial sum), ``reduce_from_tp``
follows a row-parallel product (all-reduce forward, identity backward).
FSDP: ``gather_shards`` all-gathers a leaf's shards for the forward and
reduce-scatters (sums) its gradient in the backward; the train step then
divides by the data shards, as ``train_step.average_across_ranks`` does.

Half-precision values are reduced in fp32 and cast back: one rounding of
the whole sum, as a single process's kernels round their fp32 sums once.
Integer values (the w8a8 int32 accumulators) reduce exactly.

Backends: gloo reduces and broadcasts CUDA tensors but gathers host
tensors only, so its gathers stage through the host; its reduce-scatter is
an all-reduce of which each rank keeps its chunk.  NCCL (a card per rank)
runs each collective on the card.  A group of one rank, or none, is the
identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from deer_vla_tpu_torch.parallel.mesh import AxisGroup

_HALF = (torch.bfloat16, torch.float16)


def _active(g: Optional[AxisGroup]) -> bool:
    return g is not None and g.size > 1


def _nccl(g: AxisGroup) -> bool:
    return dist.get_backend(g.group) == "nccl"


def all_reduce(t: torch.Tensor, g: Optional[AxisGroup],
               op: str = "sum") -> torch.Tensor:
    """The sum (or "max") of ``t`` over the group, as a new tensor of t's
    dtype; half precision is reduced in fp32."""
    if not _active(g):
        return t
    work = t.float() if t.dtype in _HALF else t.clone()
    dist.all_reduce(work, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=g.group)
    return work.to(t.dtype)


def all_gather(t: torch.Tensor, g: Optional[AxisGroup],
               dim: int) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along
    ``dim`` in the group's rank order."""
    if not _active(g):
        return t
    src = t.contiguous()
    if src.is_cuda and not _nccl(g):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(g.size)]
    dist.all_gather(parts, src, group=g.group)
    return torch.cat(parts, dim).to(t.device)


def reduce_scatter(t: torch.Tensor, g: Optional[AxisGroup],
                   dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``t`` over the group
    (``dim`` divides by the group's size); half precision in fp32."""
    if not _active(g):
        return t
    if _nccl(g):
        work = t.float() if t.dtype in _HALF else t
        src = work.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // g.size,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=g.group)
        return out.movedim(0, dim).to(t.dtype)
    return all_reduce(t, g).chunk(g.size, dim)[g.index].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.g), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.g, ctx.dim), None, None


def copy_to_tp(x: torch.Tensor, tp: Optional[AxisGroup]) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` itself; in the
    backward its gradient is summed over the tp group."""
    if not _active(tp) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[AxisGroup]) -> torch.Tensor:
    """The output of a row-parallel product: the sum of the ranks' partial
    products over the tp group (fp32 for half precision, cast back)."""
    if not _active(tp):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, tp)
    return all_reduce(x, tp)


def gather_shards(x: torch.Tensor, g: Optional[AxisGroup],
                  dim: int) -> torch.Tensor:
    """A leaf's fsdp shards gathered along ``dim``; its gradient is
    reduce-scattered (summed) back onto the shards."""
    if not _active(g):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherShards.apply(x, g, dim)
    return all_gather(x, g, dim)
