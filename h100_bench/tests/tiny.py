"""A cell of the benchmark at a tiny size, for the CPU: the real files of a
configuration, traffic mix and cell, with the model cut to 2 + 2 layers of
width 64 over 64 audio positions (a 2.56 s window) and short traffic. The
port's configuration is cut alike by ``tiny_port``, which the tests that
build the program take as a fixture, and for training through the mix's
``port_config``."""

from __future__ import annotations

import copy

from core.runner import load_spec
from core.weights import geometry

TINY = dict(d_model=64, encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=256, decoder_ffn_dim=256, encoder_layers=2, decoder_layers=2,
            max_source_positions=64)
PORT = dict(n_audio_ctx=64, d_model=64, n_heads=2, n_audio_layers=2, n_text_layers=2)


def tiny_port(monkeypatch) -> None:
    """The port's ``get_config`` with ``PORT``'s sizes over the named
    model's, where the drivers look it up."""
    from whisper_context_biasing_tpu_torch.models import config

    get = config.get_config
    monkeypatch.setattr(config, "get_config", lambda name, **kw: get(name, **{**kw, **PORT}))


def tiny_spec(cell: str, batch: int = 4, rows_per_step: int = 4, **traffic) -> dict:
    """``cell`` cut to the tiny size; ``traffic`` replaces mix parameters."""
    spec = copy.deepcopy(load_spec(cell))
    spec["config"].update(TINY)
    spec["g"] = geometry(spec["config"])
    tr = spec["traffic"]
    tr.update(window_samples=20480, duration_s=[0.5, 1.28])
    if tr["kind"] == "serve":
        tr.update(batch=batch, max_new=24, context_tokens=[4, 8],
                  corpus_token_deciles=[int(x) // 8 + 2 for x in tr["corpus_token_deciles"]])
        spec["cell"].update(check_requests=3)
    else:
        # the sizes reach the port through the mix too: ranks in other
        # processes build the tiny model without ``tiny_port``
        tr.update(rows_per_step=rows_per_step, context_tokens=[4, 12], max_label=64,
                  port_config={**tr["port_config"], **PORT})
        spec["cell"].update(batch=rows_per_step // spec["cell"]["grad_accum"] or 1,
                            reference_rows=2)
        spec["cell"]["grad_accum"] = rows_per_step // spec["cell"]["batch"]
    tr.update(traffic)
    return spec
