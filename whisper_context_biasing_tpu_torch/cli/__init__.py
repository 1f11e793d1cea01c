"""Command-line entry points with the JAX package's flag surface
(``scripts/train.py``, ``scripts/evaluation.py``, ``scripts/export_hf.py``,
``scripts/prepare_data.py``, ``scripts/transcribe.py``, ``scripts/serve.py``,
``scripts/medusa.py``, ``scripts/distill.py``, ``scripts/acceptance.py`` and
the three ``scripts/check_*.py`` harnesses)::

    python -m whisper_context_biasing_tpu_torch.cli.train --model base.en ...
    python -m whisper_context_biasing_tpu_torch.cli.evaluation --best_checkpoint ...
    python -m whisper_context_biasing_tpu_torch.cli.export_hf --checkpoint ... --out ...
    python -m whisper_context_biasing_tpu_torch.cli.prepare_data --source ... --out_dir ...
    python -m whisper_context_biasing_tpu_torch.cli.transcribe --audio a.wav --long ...
    python -m whisper_context_biasing_tpu_torch.cli.serve --model base.en --port 8080
    python -m whisper_context_biasing_tpu_torch.cli.medusa --medusa_heads 4 ...
    python -m whisper_context_biasing_tpu_torch.cli.distill --draft_model tiny.en ...
    python -m whisper_context_biasing_tpu_torch.cli.acceptance --configs 1,2,3,4,5
    python -m whisper_context_biasing_tpu_torch.cli.check_weightce
    python -m whisper_context_biasing_tpu_torch.cli.check_data_collator --prompt ...
    python -m whisper_context_biasing_tpu_torch.cli.check_data_loader --bias_list ...

Each module has ``parse_args(argv=None)`` and ``main(argv=None)`` and runs
nothing at import. Deviations from the JAX scripts: ``--device`` (every
entry point that runs a model; default ``cuda``, ``cpu`` for tests), one
device whatever ``--model_parallelism`` (0 or 1; a larger value raises
until ROADMAP A.9), and the port's seeded init without a checkpoint (the JAX
init's distributions, other numbers). Flags whose modules are not ported
yet raise ``NotImplementedError`` naming their ROADMAP item before any data
is read.
"""

from __future__ import annotations


def not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue {item})")


def check_model_parallelism(model_parallelism: int) -> None:
    """``--model_parallelism``: 0 and 1 run on one device (what JAX's 1 does
    with one visible card); a tensor-parallel degree raises."""
    if model_parallelism > 1:
        not_ported(f"--model_parallelism {model_parallelism} (tensor parallelism)", "A.9")


def report_devices(device) -> None:
    """Say so when more cards are visible than the one the run uses."""
    import torch

    if device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} CUDA devices visible; running on {device} alone "
              "(data parallelism is not ported yet, ROADMAP Queue A.9)")
