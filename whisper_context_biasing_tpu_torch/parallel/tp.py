"""The collectives of Megatron tensor parallelism, written out where GSPMD
inserts them in the JAX package (``parallel/sharding.py`` there has no code
for them: XLA adds them).

The loss is replicated over the "model" axis, so every rank of a model
group holds the whole gradient of a replicated activation. Two conjugate
functions keep it so:

  * ``copy_to_model`` at the input of a column-parallel product (q, k, v,
    fc1, the vocab logits): identity forward, all-reduce backward, since
    each rank's shard of the product contributes part of the input's
    gradient;
  * ``reduce_from_model`` at the output of a row-parallel product (the
    attention output, fc2) and of the vocab-parallel embedding: all-reduce
    forward, identity backward.

``torch.distributed.nn.functional.all_reduce`` is not the second one: it
all-reduces the gradient too, which would multiply every gradient under it
by the model axis's size.

``gather_vocab`` joins the vocab-parallel logits along the vocab: the bias
trie, suppression, the timestamp rules and the loss read whole rows. An
uneven vocabulary (51,865 or 51,866 tokens over 2 or 4 ranks) is padded to
equal shards, with zero rows at the end of the last one; the gather drops the
padded columns, so they never reach a logits processor.

Every collective raises when it fails; nothing falls back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class TensorParallel:
    """A rank's place on the mesh's "model" axis: the process group, its
    size and the rank's index in it. A sharded ``Whisper`` holds one as
    ``model.tp``; its sharded products hold it as ``tp_col`` / ``tp_row``."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)


def shard_bounds(n: int, size: int, rank: int) -> tuple[int, int, int]:
    """(start, stop, width) of rank's shard of a dimension of ``n`` over
    ``size`` ranks: equal widths of ceil(n / size), the last shard padded
    when ``size`` does not divide ``n``."""
    width = -(-n // size)
    start = min(rank * width, n)
    return start, min(start + width, n), width


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, n):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x, group=tp.group)
        ctx.width, ctx.start = x.shape[-1], tp.rank * x.shape[-1]
        return torch.cat(parts, dim=-1)[..., :n]

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1]
        g = torch.nn.functional.pad(g, (0, max(0, ctx.start + ctx.width - n)))
        return g[..., ctx.start:ctx.start + ctx.width], None, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward, all-reduce over "model" backward."""
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """All-reduce (sum) over "model" forward, identity backward."""
    return _ReduceFromModel.apply(x, tp.group)


def max_over_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Elementwise max over "model" (not differentiable): the int8
    cross-K/V scale, an amax over all of D, from each rank's D / tp."""
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.group)
    return x


def gather_vocab(logits: torch.Tensor, tp: TensorParallel, n_vocab: int) -> torch.Tensor:
    """(..., V / tp) logits of each rank -> (..., n_vocab), the padding
    columns of an uneven vocabulary dropped. Backward: each rank's slice of
    the (replicated) gradient."""
    return _GatherLastDim.apply(logits, tp, n_vocab)


def vocab_embedding(table: torch.Tensor, tokens: torch.Tensor, tp: TensorParallel,
                    n_vocab: int, rows=None) -> torch.Tensor:
    """Vocab-parallel lookup: each rank looks up the ids of its shard of
    ``table`` (V / tp, D) (``rows(table_rows)`` maps the gathered rows to the
    embedding, e.g. an int8 table's widening), zeroes the others, and the sum
    over "model" puts every row together."""
    start, _, width = shard_bounds(n_vocab, tp.size, tp.rank)
    local = tokens - start
    inside = (local >= 0) & (local < width)
    idx = torch.where(inside, local, 0)
    e = table[idx] if rows is None else rows(idx)
    e = torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
    return reduce_from_model(e, tp)
