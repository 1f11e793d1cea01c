"""Training loop: the fine-tune with periodic WER evaluation, checkpoints,
early stopping and resume.

The counterpart of the JAX package's ``train/loop.py``, the native
replacement for HF ``Seq2SeqTrainer`` as the reference drives it
(scripts/train.py:225-273):

  * effective batch = per-step batch × grad accumulation (8×4)
  * AdamW + cosine w/ warmup, weight decay, grad clipping
  * eval every ``eval_steps`` optimizer steps: batched greedy (or beam)
    decode over the KV cache, scored by the compute_wer flow, refs_and_pred.txt written
  * checkpoint every ``save_steps`` (the JAX package's npz layout) with the
    accumulated log_history, written on a background thread; retention
    keep-N + best (load_best_model_at_end on lowest eval_wer)
  * early stopping patience on eval_wer
  * resume from the newest local checkpoint, optimizer state included

Generation during eval is UNPROMPTED (prefix = <|startoftranscript|> only),
matching the reference pipeline; ``prompt_generation=True`` decodes from
each label's context prefix instead.

The loop trains a ``Whisper`` model (f32 masters, ``build_model(...,
train=True)``) in place through the port's ``TrainState``; with
``cfg.fused_ln_qkv`` / ``fused_ln_mlp`` (the ``--fused_ln`` switch) its
steps and the eval's encoder run the fused LayerNorm+matmul kernel. With
``spec_augment`` the step masks the features (``train/augment.py``); with
``lora_rank > 0`` it trains LoRA adapters over the frozen model
(``train/lora.py``): checkpoints hold the adapter tree with ``lora_rank`` and
``lora_alpha`` stamped in ``trainer_state.json``, evaluations and the
returned model have the merged dense weights. Under a (data, model) mesh
(``parallel/``; one process per card) the model is sharded, each rank keeps
its rows of every global batch, evaluations decode their rows and gather
the tokens, and checkpoints hold the whole gathered npz (either package
loads it, on any mesh; a resume re-shards it). Rank 0 alone logs and writes
files. Options whose modules are not ported yet raise
``NotImplementedError`` naming their ROADMAP item: the Orbax backend and
LoRA under a mesh (A.9). With ``hub_model_id``
each save pushes the output dir to the Hub and a resume without a local
checkpoint tries a Hub snapshot, as in JAX; offline both degrade to a
warning (``utils/hub.py``).
"""

from __future__ import annotations

import copy
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..data.collator import SpeechSeq2SeqCollator
from ..data.prefetch import BatchLoader, prefetch_to_device
from ..decode.beam import beam_decode
from ..decode.bias_processor import sanitize_bias_spans
from ..decode.greedy import greedy_decode, pack_prefixes
from ..decode.medusa import medusa_greedy_decode
from ..metrics.evaluate import score_predictions
from ..models.config import WhisperConfig
from ..models.convert import build_model
from ..models.medusa import split_medusa
from ..models.whisper import Whisper
from ..parallel.multihost import process_count, process_index
from ..parallel.sharding import load_params, shard_batch, shard_opt_state, shard_params
from ..utils import hub
from ..utils.logging import RunLogger
from .checkpoint import (
    find_best_checkpoint,
    host_arrays,
    latest_checkpoint,
    load_checkpoint,
    write_checkpoint,
)
from .augment import SpecAugmentConfig
from .lora import (
    init_lora_params,
    init_lora_state,
    load_lora_checkpoint,
    lora_host_arrays,
    lora_param_count,
    make_lora_train_step,
    merge_lora,
)
from .optim import make_optimizer
from .step import init_train_state, make_train_step


@dataclass
class TrainingConfig:
    output_dir: str
    per_device_train_batch_size: int = 8
    per_device_eval_batch_size: int = 2
    gradient_accumulation_steps: int = 4
    learning_rate: float = 1e-5
    num_train_epochs: float = 5
    warmup_steps: int = 50
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    eval_steps: int = 135
    save_steps: int = 135
    logging_steps: int = 50
    save_total_limit: int = 1
    checkpoint_backend: str = "npz"  # "orbax" is not ported (ROADMAP A.9)
    early_stopping_patience: int = 3
    generation_max_length: int = 225
    bias_weight: float = 1.5
    freeze_encoder: bool = False
    seed: int = 42
    label_pad_multiple: int = 32
    prompt_generation: bool = False
    bias_boost: float = 0.0
    load_best_model_at_end: bool = True
    dataloader_num_workers: int = 4
    mel_on_device: bool = False  # dataset must be built with return_audio=True
    spec_augment: bool = False   # mel masking in the step (train/augment.py)
    lora_rank: int = 0           # >0: train rank-r LoRA adapters instead of
                                 # the full weights (train/lora.py)
    lora_alpha: float = 16.0
    use_wandb: bool = False
    wandb_project: str | None = None
    # reference hub sync (utils/hub.py); offline each call degrades to a
    # warning. push_to_hub="every_save" (scripts/train.py:83-85): fires only
    # when hub_model_id is set
    hub_model_id: str | None = None
    hub_token: str | None = None
    hub_push_on_save: bool = True


def _check_ported(tcfg: TrainingConfig) -> None:
    if tcfg.lora_rank > 0 and tcfg.mel_on_device:
        raise ValueError("lora_rank with mel_on_device is not supported")
    if tcfg.checkpoint_backend == "orbax":
        raise NotImplementedError("the Orbax checkpoint backend is not ported yet "
                                  "(ROADMAP Queue A.9)")
    if tcfg.checkpoint_backend != "npz":
        raise ValueError(f"unknown checkpoint backend {tcfg.checkpoint_backend!r} "
                         "(expected 'npz' or 'orbax')")


def evaluate_wer(
    model: Whisper,
    tokenizer,
    dataset,
    collator: SpeechSeq2SeqCollator,
    batch_size: int,
    max_new: int,
    refs_pred_file: str | None = None,
    prompt_generation: bool = False,
    bias_boost: float = 0.0,
    num_beams: int = 1,
    num_workers: int = 4,
    mesh=None,
    medusa: dict | None = None,
) -> dict:
    """Batched greedy (or beam, ``num_beams > 1``) decode over a dataset +
    compute_wer scoring, on the model's device. Returns {"wer": percent}.

    Item prep runs on BatchLoader threads, the final partial batch is padded
    up to ``batch_size`` by repeating its first row (stripped after decode),
    prefix lengths are bucketed to multiples of 32 and bias-span dims to
    multiples of 4, as in the JAX package (there for its compiled shapes;
    here they keep the batches, and so the results, the same). ``medusa``
    (a head dict) decodes greedily through ``medusa_greedy_decode``: the same
    tokens, fewer model passes with trained heads.

    ``mesh``: each decode batch's rows shard over its "data" axis, with
    ``model`` this rank's shard (``parallel.shard_params``); every rank gets
    the whole result, and rank 0 alone writes ``refs_pred_file``."""
    # shallow-copy the collator: mid-training evals run while the training
    # BatchLoader threads still collate with the shared instance — mutating
    # span_pad_multiple on it would change train batch shapes mid-flight
    collator = copy.copy(collator)

    all_preds: list[list[int]] = []
    all_labels: list[list[int]] = []

    def collate(items):
        batch = collator(items)
        if prompt_generation:
            prefixes = []
            for item in items:
                seq = np.asarray(item["labels"]).tolist()
                sot_at = seq.index(tokenizer.sot) if tokenizer.sot in seq else 0
                prefixes.append(seq[: sot_at + 1])  # context + sot
        else:
            prefixes = [[tokenizer.sot]] * len(items)
        batch["_prefixes"] = prefixes
        return batch

    if collator.max_spans is None and collator.span_pad_multiple is None:
        collator.span_pad_multiple = 4
    if num_beams > 1:
        decode_fn = beam_decode
    elif medusa is not None:
        decode_fn = medusa_greedy_decode
    else:
        decode_fn = greedy_decode
    # the call-signature diagnostic (utils.compile_count.CountedJit)
    programs_before = decode_fn.cache_size()
    loader = BatchLoader(dataset, collate, batch_size, num_workers=num_workers)
    for batch in loader:
        _eval_decode_batch(batch, all_preds, all_labels, model, tokenizer, collator,
                           batch_size, max_new, bias_boost, num_beams, medusa, mesh)
    result = score_predictions(all_preds, all_labels, tokenizer,
                               refs_pred_file if process_index() == 0 else None)
    # static-shape discipline, as in JAX: one eval pass should need only a
    # handful of decode signatures (prefix-length buckets). Logged, not
    # returned: the result dict is the test_results.json artifact
    new_programs = decode_fn.cache_size() - programs_before
    if new_programs:
        print(f"evaluate_wer: compiled {new_programs} decode program(s)")
    return result


def _pad_rows(a: np.ndarray, b_full: int) -> np.ndarray:
    """Repeat the first row to reach the static batch size."""
    if a.shape[0] == b_full:
        return a
    reps = np.repeat(a[:1], b_full - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def _eval_decode_batch(batch, all_preds, all_labels, model: Whisper, tokenizer, collator,
                       batch_size, max_new, bias_boost, num_beams, medusa=None, mesh=None):
    prefixes = batch.pop("_prefixes")
    b = len(prefixes)
    ids, mask = pack_prefixes(prefixes, tokenizer.eot, pad_to_multiple=32)
    feats = np.asarray(batch["input_features"])
    if b < batch_size:  # pad the trailing partial batch to the full shape
        feats = _pad_rows(feats, batch_size)
        ids = _pad_rows(ids, batch_size)
        mask = _pad_rows(mask, batch_size)
    spans = None
    if bias_boost and "bias_spans" in batch:
        # drop the collator's all-empty (B,1,1) zeros fallback — it is
        # NOT a real length-1 span of token id 0
        spans = sanitize_bias_spans(batch["bias_spans"])
        if spans is not None:
            spans = _pad_rows(np.asarray(spans), batch_size)
    kw = dict(max_new=max_new, eot_id=tokenizer.eot, bias_spans=spans, bias_boost=bias_boost,
              span_pad_id=collator.bias_span_pad_id, device=next(model.parameters()).device)
    if num_beams > 1:
        toks = beam_decode(model, feats, ids, mask, num_beams=num_beams, mesh=mesh,
                           **kw).best.cpu().numpy()
        lens = np.cumprod(toks != tokenizer.eot, axis=1).sum(axis=1)
    else:
        if medusa is not None:
            heads, n_chains = split_medusa(medusa)
            res = medusa_greedy_decode(model, heads, feats, ids, mask, n_chains=n_chains,
                                       mesh=mesh, **kw)
        else:
            res = greedy_decode(model, feats, ids, mask, mesh=mesh, **kw)
        toks = res.tokens.cpu().numpy()
        lens = res.lengths.cpu().numpy()
    for i in range(b):
        all_preds.append(toks[i, : lens[i]].tolist())
        all_labels.append(batch["labels"][i].tolist())


def train_and_evaluate(
    model_cfg: WhisperConfig,
    params: dict | None,
    tokenizer,
    data_train,
    data_eval,
    collator: SpeechSeq2SeqCollator,
    tcfg: TrainingConfig,
    resume: bool = False,
    shard_fn=None,
    logger: RunLogger | None = None,
    mesh=None,
    device="cuda",
):
    """Runs the full fine-tune on ``device`` from ``params`` (a state dict:
    ``params_from_jax``, ``load_checkpoint``, or None for the seeded init).
    Returns (the trained ``Whisper`` model, log_history); with
    ``load_best_model_at_end`` the model holds the best checkpoint's
    weights. Under ``lora_rank > 0`` the model from ``params`` stays frozen
    and the returned one has the adapters merged into it.

    ``mesh`` (``parallel.auto_mesh``): the model is sharded
    (``shard_params``) and the returned one is this rank's shard
    (``parallel.gather_params`` gives the whole); evaluations decode over
    "data". ``shard_fn`` maps each (global) batch to this rank's part;
    under a mesh it defaults to ``shard_batch`` over "data"."""
    _check_ported(tcfg)
    if mesh is not None and tcfg.lora_rank > 0:
        raise NotImplementedError("LoRA under a mesh is not ported yet (ROADMAP Queue A.9)")
    device = resolve_device(device)
    accum = tcfg.gradient_accumulation_steps
    if shard_fn is None and mesh is not None:
        def shard_fn(b):
            return shard_batch(b, mesh, extra_leading_axes=1 if accum > 1 else 0)
    lead = process_index() == 0
    os.makedirs(tcfg.output_dir, exist_ok=True)
    if logger is None and lead:
        logger = RunLogger(tcfg.output_dir, use_wandb=tcfg.use_wandb,
                           wandb_project=tcfg.wandb_project)
    chunk = tcfg.per_device_train_batch_size * accum
    steps_per_epoch = max(1, len(data_train) // chunk)
    total_steps = int(steps_per_epoch * tcfg.num_train_epochs)

    optimizer = make_optimizer(
        peak_lr=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
        total_steps=total_steps, weight_decay=tcfg.weight_decay,
        max_grad_norm=tcfg.max_grad_norm,
    )
    sa_cfg = SpecAugmentConfig() if tcfg.spec_augment else None
    lora = tcfg.lora_rank > 0
    if lora:
        lora_step = make_lora_train_step(
            model_cfg, optimizer, alpha=tcfg.lora_alpha, bias_weight=tcfg.bias_weight,
            grad_accum=accum, spec_augment=sa_cfg, augment_seed=tcfg.seed)
    else:
        step_fn = make_train_step(
            model_cfg, optimizer, bias_weight=tcfg.bias_weight, grad_accum=accum,
            freeze_encoder=tcfg.freeze_encoder, mel_on_device=tcfg.mel_on_device,
            spec_augment=sa_cfg, augment_seed=tcfg.seed, mesh=mesh,
        )

    log_history: list[dict] = []
    start_step = 0
    resumed = resumed_opt_state = None
    if resume:
        ckpt = latest_checkpoint(tcfg.output_dir)
        if ckpt is None and tcfg.hub_model_id:
            # no local checkpoint: fall back to a Hub snapshot (reference
            # scripts/train.py:169-189), gated like every other hub call
            print(f"no local checkpoint; trying hub snapshot {tcfg.hub_model_id}")
            if hub.sync_from_hub(tcfg.hub_model_id, tcfg.output_dir, tcfg.hub_token):
                ckpt = latest_checkpoint(tcfg.output_dir)
        if ckpt:
            # restore optimizer moments + schedule count too: re-initializing
            # them would silently re-warm the LR and zero the Adam moments
            if lora:  # the checkpoint holds the adapters; the base stays params
                resumed, resumed_opt_state, meta = load_lora_checkpoint(
                    ckpt, load_opt_state=True, device=device)
            else:
                params, resumed_opt_state, meta = load_checkpoint(ckpt, model_cfg,
                                                                  load_opt_state=True)
            start_step = meta.get("step", 0)
            log_history = meta.get("log_history", [])
            print(f"resumed from {ckpt} at step {start_step} "
                  f"(opt_state {'restored' if resumed_opt_state is not None else 'reset'})")

    model = build_model(model_cfg, params, device=device, train=True)
    if mesh is not None:
        model = shard_params(model, mesh)
    if lora:
        base = model.requires_grad_(False)
        adapters = resumed if resumed is not None else init_lora_params(
            base, tcfg.lora_rank, torch.Generator().manual_seed(tcfg.seed),
            include_encoder=not tcfg.freeze_encoder)
        print(f"LoRA rank {tcfg.lora_rank}: {lora_param_count(adapters):,} trainable adapter "
              "params")
        state = init_lora_state(adapters, optimizer)
        step_fn = lambda st, b: lora_step(st, base, b)  # noqa: E731

        def current_model():  # evaluations see the merged dense weights
            return merge_lora(base, state.model, tcfg.lora_alpha)
    else:
        state = init_train_state(model, optimizer)

        def current_model():
            return model
    if resumed_opt_state is not None:
        if mesh is not None:
            resumed_opt_state = shard_opt_state(resumed_opt_state, model, mesh)
        resumed_opt_state.mu = [m.to(device) for m in resumed_opt_state.mu]
        resumed_opt_state.nu = [v.to(device) for v in resumed_opt_state.nu]
        state.opt_state = resumed_opt_state
    state.step = start_step

    best_wer = min((e["eval_wer"] for e in log_history if "eval_wer" in e), default=float("inf"))
    # latest eval (value + the step whose params produced it) at (re)start;
    # updated in the eval branch thereafter
    last_wer, last_eval_step = next(
        ((e["eval_wer"], e["step"]) for e in reversed(log_history)
         if "eval_wer" in e), (None, None))
    bad_evals = 0
    step = start_step
    t0 = time.time()
    loss_window: list[float] = []
    stop = False
    save_thread: threading.Thread | None = None

    def prep(items):
        batch = collator(items)
        if "bias_spans" in batch and sanitize_bias_spans(batch["bias_spans"]) is None:
            # all-empty fallback: replace with an all-pad span (span_len 0,
            # weights stay 1.0) instead of the zeros quirk the loss would
            # read as a real span of token id 0
            batch["bias_spans"] = np.full_like(
                np.asarray(batch["bias_spans"]), collator.bias_span_pad_id)
        if accum > 1:
            batch = {
                k: v.reshape((accum, tcfg.per_device_train_batch_size) + v.shape[1:])
                for k, v in batch.items()
            }
        # this rank's rows, cut on the host before the device copy
        return batch if shard_fn is None else shard_fn(batch)

    # threaded item prep (audio decode + mel + tokenize) + double-buffered
    # device copies: the card never waits on host-side batch building
    loader = BatchLoader(
        data_train, prep, chunk, shuffle=True, seed=tcfg.seed, drop_last=True,
        num_workers=tcfg.dataloader_num_workers,
    )
    # resumable data order: continue with the epoch permutation the run
    # would have had, skipping the already-trained batches of the partial
    # epoch (BatchLoader.resume docstring)
    loader.resume(start_step // steps_per_epoch, start_step % steps_per_epoch)

    for epoch in range(int(np.ceil(tcfg.num_train_epochs))):
        if stop or step >= total_steps:
            break
        for batch in prefetch_to_device(loader, size=2, device=device):
            if stop or step >= total_steps:
                break
            state, metrics = step_fn(state, batch)
            step += 1
            loss_window.append(float(metrics["loss"]))

            if step % tcfg.logging_steps == 0:
                entry = {
                    "step": step, "epoch": round(step / steps_per_epoch, 3),
                    "loss": float(np.mean(loss_window)),
                    "grad_norm": float(metrics["grad_norm"]),
                    "elapsed_s": round(time.time() - t0, 1),
                }
                loss_window.clear()
                log_history.append(entry)
                if logger is not None:
                    logger.log(entry)

            if step % tcfg.eval_steps == 0:
                last_wer = evaluate_wer(
                    current_model(), tokenizer, data_eval, collator,
                    tcfg.per_device_eval_batch_size,
                    tcfg.generation_max_length - 1,
                    refs_pred_file=os.path.join(tcfg.output_dir, "refs_and_pred.txt"),
                    prompt_generation=tcfg.prompt_generation,
                    bias_boost=tcfg.bias_boost, mesh=mesh,
                )["wer"]
                entry = {"step": step, "eval_wer": last_wer}
                last_eval_step = step
                log_history.append(entry)
                if logger is not None:
                    logger.log(entry)
                if last_wer < best_wer:
                    best_wer, bad_evals = last_wer, 0
                else:
                    bad_evals += 1
                if bad_evals >= tcfg.early_stopping_patience:
                    print(f"early stopping at step {step} (patience "
                          f"{tcfg.early_stopping_patience} on eval_wer)")
                    stop = True

            # saving is independent of evaluation (save_steps need not be a
            # multiple of eval_steps); the metadata carries the latest wer
            # plus the step it was measured at, so find_best_checkpoint can
            # attribute the metric only to the params that achieved it.
            # The arrays are copied to the host here, and the write runs on
            # a background thread so the step loop never blocks on disk
            if step % tcfg.save_steps == 0 or stop:
                meta = {"log_history": list(log_history)}
                if last_wer is not None:
                    meta["eval_wer"] = last_wer
                    meta["eval_step"] = last_eval_step
                if save_thread is not None:
                    save_thread.join()
                if lora:
                    meta["lora_rank"] = tcfg.lora_rank
                    meta["lora_alpha"] = tcfg.lora_alpha
                    host_params, host_opt = lora_host_arrays(state.model, state.opt_state)
                else:  # gathered over "model" on every rank
                    host_params, host_opt = host_arrays(model, state.opt_state)
                if not lead:
                    continue

                def _save_and_push(step=step, params=host_params, opt=host_opt, meta=meta):
                    write_checkpoint(tcfg.output_dir, step, params, opt, meta,
                                     tcfg.save_total_limit)
                    # reference PushToHubOnSaveCallback parity: every save
                    # pushes the output dir (checkpoint-N/ layout kept)
                    if tcfg.hub_push_on_save and tcfg.hub_model_id:
                        hub.push_to_hub_if_exists(tcfg.output_dir, tcfg.hub_model_id,
                                                  tcfg.hub_token)

                save_thread = threading.Thread(target=_save_and_push)
                save_thread.start()

    if save_thread is not None:
        save_thread.join()
    if process_count() > 1:  # rank 0's files are written before anyone reads them
        torch.distributed.barrier()
    if tcfg.load_best_model_at_end:
        best = find_best_checkpoint(tcfg.output_dir)
        if best and lora:
            state.model, _, _ = load_lora_checkpoint(best, device=device)
        elif best:
            best_params, _, _ = load_checkpoint(best, model_cfg)
            load_params(model, best_params)
        if best:
            print(f"loaded best checkpoint: {best} (eval_wer {best_wer:.3f})")
    # downstream consumers (test-set eval, safetensors export, serving) get
    # ordinary dense weights
    return current_model(), log_history
