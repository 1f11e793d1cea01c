"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct.
Tiny cells on the CPU, with the cells' own limits."""

import pytest
import torch

from core import faults, runner
from drivers import serve, train
from tiny import tiny_spec

torch.set_num_threads(2)
SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def _tiny(tiny_port):
    pass


def _run(monkeypatch, cell, module, fault=None, every_request=False, **kw):
    """A tiny run of 0.3 s; ``every_request`` judges every request the
    window completed, not a sample of three. A sound serving run does: how
    many batches the CPU completes in 0.3 s moves with its load, and so
    does the sample drawn from them, whose few tokens' mean gap one
    near-tie at rounding (1.6e-3 at this size, seed and context) lifts
    over the limit."""
    if fault:
        orig = module.port
        monkeypatch.setattr(module, "port", lambda: fault(orig()))
    spec = tiny_spec(cell, **kw)
    if every_request:
        spec["cell"]["check_requests"] = 10 ** 6
    return runner.run_cell(spec, SEED, 0.3, False, "cpu")


def test_sound_serving_run_is_correct(monkeypatch):
    assert _run(monkeypatch, "serve.base.en.biased32", serve, every_request=True)["correct"]


@pytest.mark.parametrize("context", [[4, 8], [0, 0]])
def test_serving_mix_without_bias_words_runs_correct(monkeypatch, context):
    """A mix with no bias words (and no context) decodes with no bias
    spans at all."""
    line = _run(monkeypatch, "serve.base.en.biased32", serve, every_request=True,
                bias_words=[0, 0], context_tokens=context)
    assert line["correct"] and line["attempted"] > 0, line["checks"]


@pytest.mark.parametrize("name", sorted(faults.SERVE))
def test_serving_fault_is_caught(monkeypatch, name):
    line = _run(monkeypatch, "serve.base.en.biased32", serve, faults.SERVE[name])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["train.base.en.weightce", "train.large-v3.weightce"])
def test_sound_training_run_is_correct(monkeypatch, cell):
    assert _run(monkeypatch, cell, train, rows_per_step=8)["correct"]


@pytest.mark.parametrize("name", sorted(faults.TRAIN))
@pytest.mark.parametrize("cell", ["train.base.en.weightce", "train.large-v3.weightce"])
def test_training_fault_is_caught(monkeypatch, cell, name):
    line = _run(monkeypatch, cell, train, faults.TRAIN[name], rows_per_step=8)
    assert not line["correct"], line["checks"]
