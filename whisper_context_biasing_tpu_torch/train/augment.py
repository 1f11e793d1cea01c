"""SpecAugment for Whisper fine-tuning: frequency and time masking of the
log-mel features inside the training step.

The counterpart of the JAX package's ``train/augment.py``. The reference's
only augmentation is the 5% text-prompt perturbation
(data_utils/data_loader.py:214-223); this adds the classic policy (Park et
al. 2019) as a transform of the batch's features on their device, train
time only. The function comes in two halves:

  * ``draw_spec_augment_masks``: per-row frequency and time masks, each the
    union of ``n`` runs ``[start, start + w)`` with ``w ~ U[0, max_width]``
    and ``start ~ U[0, axis_len - 1]``, clipped at the axis end, drawn from
    a ``torch.Generator`` on the features' device (other numbers than
    ``jax.random``'s for one seed, the same distribution)
  * ``apply_spec_augment_masks``: masked cells take each row's mean log-mel
    value (the 'mean' fill of the paper: Whisper mels are globally scaled,
    so zeros would be an out-of-distribution energy)

``make_augment_fn`` seeds the generator from ``(augment_seed, step)``, so a
resumed run draws the same masks at the same step, as ``fold_in`` does in
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SpecAugmentConfig:
    n_freq_masks: int = 2
    max_freq_width: int = 27      # of 80/128 mel bins (LibriSpeech LD policy)
    n_time_masks: int = 2
    max_time_frac: float = 0.05   # per mask, fraction of the frame axis


def _axis_masks(b: int, axis_len: int, n_masks: int, max_width: int,
                generator: torch.Generator, device) -> torch.Tensor:
    """(B, axis_len) bool: the union of ``n_masks`` random runs per row."""
    idx = torch.arange(axis_len, device=device)
    mask = torch.zeros((b, axis_len), dtype=torch.bool, device=device)
    for _ in range(n_masks):
        w = torch.randint(0, max_width + 1, (b,), generator=generator, device=device)
        s = torch.randint(0, max(axis_len, 1), (b,), generator=generator, device=device)
        mask |= (idx[None, :] >= s[:, None]) & (idx[None, :] < (s + w)[:, None])
    return mask


def draw_spec_augment_masks(b: int, n_mels: int, n_frames: int, generator: torch.Generator,
                            cfg: SpecAugmentConfig = SpecAugmentConfig()):
    """(freq mask (B, n_mels), time mask (B, n_frames)), bool, on the
    generator's device; a time run is at most ``max_time_frac`` of the
    frames (at least 1)."""
    device = generator.device
    fmask = _axis_masks(b, n_mels, cfg.n_freq_masks, cfg.max_freq_width, generator, device)
    max_t = max(1, int(n_frames * cfg.max_time_frac))
    tmask = _axis_masks(b, n_frames, cfg.n_time_masks, max_t, generator, device)
    return fmask, tmask


def apply_spec_augment_masks(feats: torch.Tensor, fmask: torch.Tensor,
                             tmask: torch.Tensor) -> torch.Tensor:
    """feats (B, n_mels, T) with the cells of ``fmask`` (B, n_mels) rows and
    ``tmask`` (B, T) columns set to each row's mean over (n_mels, T)."""
    masked = fmask[:, :, None] | tmask[:, None, :]
    fill = feats.mean(dim=(1, 2), keepdim=True)
    return torch.where(masked, fill.to(feats.dtype), feats)


def apply_spec_augment(feats: torch.Tensor, generator: torch.Generator,
                       cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """SpecAugment of log-mel features (B, n_mels, T): masks drawn from
    ``generator`` (on ``feats``' device), then applied. The JAX package
    takes a PRNG key where this takes the generator."""
    b, m, t = feats.shape
    return apply_spec_augment_masks(feats, *draw_spec_augment_masks(b, m, t, generator, cfg))


def step_generator(augment_seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(augment_seed, step)``: the
    same masks at the same step of a resumed run, new masks each step."""
    seed = int(np.random.SeedSequence([augment_seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed >> 1)


def make_augment_fn(spec_augment: SpecAugmentConfig, augment_seed: int, mesh=None):
    """``augment(batch, step) -> batch`` with its ``input_features`` masked,
    the masks drawn from ``step_generator(augment_seed, step)``; a leading
    microbatch axis (A, B, n_mels, T) is flattened through the masks, as in
    the JAX package. Shared by the full-weight and LoRA steps. Under a
    ``mesh`` the batch holds this rank's rows of each microbatch
    (``shard_batch``): the whole batch's masks are drawn, as one device
    draws them, and the rank takes its rows' (the sharded step masks what
    the unsharded one does)."""
    from ..parallel.mesh import DATA_AXIS, axis_index, axis_size

    if not isinstance(spec_augment, SpecAugmentConfig):
        raise TypeError("spec_augment must be a SpecAugmentConfig, got "
                        f"{type(spec_augment).__name__}")
    dp, r = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)

    def augment(batch: dict, step: int) -> dict:
        feats = batch["input_features"]
        flat = feats.reshape((-1,) + tuple(feats.shape[-2:]))
        g = step_generator(augment_seed, step, flat.device)
        fmask, tmask = draw_spec_augment_masks(flat.shape[0] * dp, *flat.shape[1:], g,
                                               spec_augment)
        if dp > 1:  # row j of microbatch a is whole-batch row a * dp * b + r * b + j
            b = feats.shape[-3]
            rows = (torch.arange(flat.shape[0] // b)[:, None] * (dp * b) + r * b
                    + torch.arange(b)[None, :]).reshape(-1).to(flat.device)
            fmask, tmask = fmask[rows], tmask[rows]
        flat = apply_spec_augment_masks(flat, fmask, tmask)
        return dict(batch, input_features=flat.reshape(feats.shape))

    return augment
