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
nothing at import. ``train``, ``evaluation``, ``transcribe`` and ``serve``
run data and tensor parallelism with one process per card, launched by
``torchrun`` (``parallel.initialize_multihost`` reads its variables; the
server's ranks keep in step by the protocol in ``cli/serve.py``)::

    torchrun --nproc_per_node 4 -m whisper_context_biasing_tpu_torch.cli.train \
        --model_parallelism 2 ...   # data 2 x model 2

``--model_parallelism`` has the JAX scripts' semantics
(``parallel.auto_mesh``): 1 is data parallelism over every process, N > 1
tensor parallelism over groups of N, 0 none; ``transcribe`` meshes as
``Pipeline``'s default (1). Rank 0 alone writes files. Deviations from the
JAX scripts: ``--device`` (every entry point that runs a model; default
``cuda``, ``cpu`` for tests), a data axis that does not divide ``--batch``
raises (JAX shrinks it, leaving chips idle), ``distill`` runs on one device
(``--model_parallelism`` > 1 raises until ROADMAP Queue A.9), and the
port's seeded init without a checkpoint (the JAX init's distributions,
other numbers). Flags whose modules are not ported yet raise
``NotImplementedError`` naming their ROADMAP item before any data is read.
"""

from __future__ import annotations


def not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue {item})")


def check_model_parallelism(model_parallelism: int) -> None:
    """``--model_parallelism`` of ``distill``: 0 and 1 run on one device
    (what JAX's 1 does with one visible card); a tensor-parallel degree
    raises."""
    if model_parallelism > 1:
        not_ported(f"--model_parallelism {model_parallelism} (tensor parallelism)", "A.9")


def report_devices(device, mesh=None) -> None:
    """Say what the run uses: the mesh, or one card when more are
    visible."""
    import torch

    from ..parallel import DATA_AXIS, MODEL_AXIS, axis_size

    if mesh is not None:
        print(f"mesh: data={axis_size(mesh, DATA_AXIS)} x model={axis_size(mesh, MODEL_AXIS)} "
              f"(this process on {device})")
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} CUDA devices visible; running on {device} alone "
              "(launch one process per card with torchrun for data parallelism)")
