"""Bias-weighted cross-entropy (WeightCE), as batch tensor ops.

The counterpart of the JAX package's ``train/loss.py``, with its semantics:

  * spans are the collator's dense ``(B, N, K)`` int tensor, padded with
    ``span_pad_id``; padding is stripped before matching
  * a span matches at position j iff all its tokens equal
    ``labels[b, j:j+len]``; every position a match covers gets
    ``bias_weight``
  * special tokens (ids >= ``special_id_threshold``) are never upweighted
  * loss = sum(weight * nll * valid) / (count(valid) + 1e-8): the denominator
    is the count of valid tokens, not the weight sum
  * without spans it is plain mean CE over the valid positions
  * under data parallelism (``group``) the count is summed over the group
    first, so each rank's loss is its share of the global batch's and the
    shares (and their gradients) sum over the group to the global ones

Matching compares every (span, start, offset) triple at once; there is no
loop over windows and no host sync.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data.collator import BIAS_SPAN_PAD_ID, IGNORE_INDEX

# every Whisper special token sits at or above <|endoftext|> (50256 in the
# .en layout)
SPECIAL_ID_THRESHOLD = 50256
_SENTINEL = -1_000_000  # past the end of a row: never equals a token id


def bias_span_weights(
    labels: torch.Tensor,        # (B, S) int, IGNORE_INDEX for ignored
    bias_spans: torch.Tensor,    # (B, N, K) int, padded with span_pad_id
    bias_weight: float,
    skip_special_tokens: bool = True,
    span_pad_id: int = BIAS_SPAN_PAD_ID,
    special_id_threshold: int = SPECIAL_ID_THRESHOLD,
) -> torch.Tensor:
    """Per-token loss weights (B, S) f32: ``bias_weight`` at positions covered
    by a full contiguous span match, 1 elsewhere."""
    labels = labels.long()
    spans = bias_spans.to(labels.device).long()
    b, s = labels.shape
    k = spans.shape[-1]
    span_len = (spans != span_pad_id).sum(-1)  # (B, N)
    padded = F.pad(labels, (0, k), value=_SENTINEL)
    windows = padded.unfold(1, k, 1)[:, :s]  # (B, S, K): labels[b, j + kk]
    offset = torch.arange(k, device=labels.device)
    in_span = offset < span_len[..., None]  # (B, N, K)
    eq = windows[:, None] == spans[:, :, None]  # (B, N, S, K)
    match = ((eq | ~in_span[:, :, None]).all(-1)) & (span_len[..., None] > 0)  # (B, N, S)

    # hit[b, kk, j]: a span of length > kk matches at j, so j + kk is covered
    hit = (match[:, :, None, :] & in_span[..., None]).any(1)  # (B, K, S)
    start = torch.arange(s, device=labels.device)[None, :] - offset[:, None]  # (K, S)
    cover = (hit[:, offset[:, None], start.clamp(min=0)] & (start >= 0)).any(1)  # (B, S)
    if skip_special_tokens:
        cover = cover & (labels < special_id_threshold) & (labels >= 0)
    ones = torch.ones((), dtype=torch.float32, device=labels.device)
    return torch.where(cover, ones * bias_weight, ones)


def weighted_ce_loss(
    logits: torch.Tensor,                   # (B, S, V)
    labels: torch.Tensor,                   # (B, S) int, IGNORE_INDEX = masked
    bias_spans: torch.Tensor | None = None,  # (B, N, K) or None
    bias_weight: float = 1.5,
    skip_special_tokens: bool = True,
    span_pad_id: int = BIAS_SPAN_PAD_ID,
    special_id_threshold: int = SPECIAL_ID_THRESHOLD,
    group=None,
) -> torch.Tensor:
    """Scalar loss. With spans: sum(w * nll * valid) / count(valid); without:
    plain mean CE over the valid positions. ``group`` (a data-parallel
    process group): count(valid) is the group's, and the result this rank's
    share of the loss."""
    labels = labels.long()
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0)
    nll = F.cross_entropy(logits.float().flatten(0, 1), safe.flatten(),
                          reduction="none").view(labels.shape)
    nll = nll * valid
    count = valid.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    if bias_spans is None:
        return nll.sum() / count.clamp(min=1)
    weights = bias_span_weights(labels, bias_spans, bias_weight, skip_special_tokens,
                                span_pad_id, special_id_threshold) * valid
    return (nll * weights).sum() / (count.float() + 1e-8)
