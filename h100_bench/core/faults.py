"""Faults planted in the program's timed path, for the checks that must
catch them: each wraps one of the entry points a driver takes from the
program (the drivers' ``port()``), leaving the harness as it is."""

from __future__ import annotations

import copy
import os
import time

import torch
import torch.distributed as dist


def token_altered(p: dict) -> dict:
    """Serving: each row's middle served token is replaced by the next id
    where the decoder produces it."""
    greedy = p["greedy"]

    def wrapped(*args, **kw):
        res = greedy(*args, **kw)
        toks = res.tokens.clone()
        at = torch.clamp(res.lengths // 2, max=toks.shape[1] - 1).long()
        rows = torch.arange(toks.shape[0], device=toks.device)
        toks[rows, at] = (toks[rows, at] + 1) % 50000
        return res._replace(tokens=toks)

    return dict(p, greedy=wrapped)


def half_batch(p: dict) -> dict:
    """Serving: the decoder runs the first half of the rows only; the rest
    come back as <|endoftext|> at once."""
    greedy = p["greedy"]

    def wrapped(model, feats, ids, mask, **kw):
        b = feats.shape[0]
        h = b // 2
        part = {k: (v[:h] if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1
                    and v.shape[0] == b else v) for k, v in kw.items()}
        res = greedy(model, feats[:h], ids[:h], mask[:h], **part)
        eot = kw["eot_id"]
        toks = torch.full((b, res.tokens.shape[1]), eot, dtype=res.tokens.dtype,
                          device=res.tokens.device)
        toks[:h] = res.tokens
        lengths = torch.zeros(b, dtype=res.lengths.dtype, device=res.lengths.device)
        lengths[:h] = res.lengths
        sum_lp = torch.zeros(b, device=res.sum_logprob.device)
        return res._replace(tokens=toks, lengths=lengths, sum_logprob=sum_lp)

    return dict(p, greedy=wrapped)


def row_swap(p: dict) -> dict:
    """Server: the first two rows' results of every micro-batch of the
    ``Engine`` are handed to each other's waiters."""
    engine = p["engine"]

    class Swapped(engine):
        def _run(self, *args, **kw):
            res = super()._run(*args, **kw)
            if len(res) > 1:
                res[0], res[1] = res[1], res[0]
            return res

    return dict(p, engine=Swapped)


def train_half_batch(p: dict) -> dict:
    """Training: each microbatch loses half of its rows; the loss and the
    gradients are the mean over the rest."""
    make = p["make_step"]

    def make_step(cfg, opt, grad_accum=1, **kw):
        step = make(cfg, opt, grad_accum=grad_accum, **kw)
        axis = 1 if grad_accum > 1 else 0

        def half(state, batch):
            n = next(v for v in batch.values() if hasattr(v, "shape")).shape[axis]
            cut = {k: (v[:, :n // 2] if axis else v[:n // 2]) if hasattr(v, "shape") else v
                   for k, v in batch.items()}
            return step(state, cut)

        return half

    return dict(p, make_step=make_step)


def train_unchanged(p: dict) -> dict:
    """Training: the step computes its loss and gradients but hands back
    the state as it found it."""
    make = p["make_step"]

    def make_step(cfg, opt, **kw):
        step = make(cfg, opt, **kw)

        def unchanged(state, batch):
            params = [t.detach().clone() for t in state.model.parameters()]
            opt_state = copy.deepcopy(state.opt_state)
            state, metrics = step(state, batch)
            with torch.no_grad():
                for t, p0 in zip(state.model.parameters(), params):
                    t.copy_(p0)
            state.opt_state = opt_state
            return state, metrics

        return unchanged

    return dict(p, make_step=make_step)


def train_no_allreduce(p: dict) -> dict:
    """Training across cards: the step leaves out every exchange between
    the ranks (the gradient all-reduce and the loss's global count), so
    each rank steps on its own rows' gradient alone."""
    make = p["make_step"]

    def make_step(cfg, opt, mesh=None, **kw):
        return make(cfg, opt, **kw)

    return dict(p, make_step=make_step)


def _on_rank_1(then):
    """A fault of the harness's own tests, not of the program: rank 1's
    first step calls ``then`` instead."""

    def fault(p: dict) -> dict:
        make = p["make_step"]

        def make_step(*args, **kw):
            step = make(*args, **kw)
            return (lambda state, batch: then()) if dist.get_rank() == 1 else step

        return dict(p, make_step=make_step)

    return fault


SERVE = {"token_altered": token_altered, "half_batch": half_batch}
# the server kind can also hand a result to the wrong request
ENGINE = {"row_swap": row_swap}
TRAIN = {"half_batch": train_half_batch, "unchanged": train_unchanged}
# a cell across cards can also lose the exchange between them
ACROSS = {"no_allreduce": train_no_allreduce}
# a rank that fails or stalls: the run must end non-zero within its timeout
RANKS = {"rank_dies": _on_rank_1(lambda: os._exit(7)),
         "rank_stalls": _on_rank_1(lambda: time.sleep(10 ** 6))}
TRAIN_ALL = {**TRAIN, **ACROSS, **RANKS}
