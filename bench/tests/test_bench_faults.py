"""Each fault a cell can have, planted under the timed path, makes the run
come out not correct (the harness's look for a card skipped: the smoke
sizes on the CPU).  The cells run on one chip, so no exchange between
chips can be left out."""

from __future__ import annotations

import pytest
import torch

from benchlib import SERVE_CELLS, TRAIN_CELLS, run_smoke

from bench import control


def _state_unchanged_serve(monkeypatch):
    """The decode step works on a copy of its state: the caches and
    recurrent states never advance."""
    from repro_torch.models import transformer as TF
    orig = TF.decode_step

    def step(params, state, *a, **kw):
        copy = {k: {n: t.clone() for n, t in v.items()}
                for k, v in state.items()}
        logits, _ = orig(params, copy, *a, **kw)
        return logits, state
    monkeypatch.setattr(TF, "decode_step", step)


def _half_batch_serve(monkeypatch):
    """Only the first half of the batch's rows is computed; the others
    take their logits."""
    from repro_torch.models import transformer as TF
    orig = TF.decode_step

    def step(params, state, token, *a, **kw):
        logits, state = orig(params, state, token, *a, **kw)
        n = logits.shape[0] // 2
        return torch.cat([logits[:n], logits[:n]])[:logits.shape[0]], state
    monkeypatch.setattr(TF, "decode_step", step)


def _token_altered_serve(monkeypatch):
    """The last token of each answer is altered where ``generate`` makes
    it."""
    from repro_torch.serve import engine
    orig = engine.generate

    def generate(params, cfg, prompts, max_new, *a, **kw):
        out = orig(params, cfg, prompts, max_new, *a, **kw)
        out[:, -1] = (out[:, -1] + 1) % cfg.vocab_size
        return out
    monkeypatch.setattr(engine, "generate", generate)


def _state_unchanged_train(monkeypatch):
    """The optimizer returns the parameters and moments unchanged."""
    from repro_torch.train import step as S

    def update(params, grads, state, lr, **kw):
        return params, state, {"grad_norm": torch.zeros(())}
    monkeypatch.setattr(S, "adamw_update", update)


def _half_batch_train(monkeypatch):
    """The loss is the mean over the first half of the batch's rows."""
    from repro_torch.models import transformer as TF
    monkeypatch.setattr(TF, "loss_fn", control.half_batch(TF.loss_fn))


def _gradient_altered_train(monkeypatch):
    """One leaf's gradient is doubled where the step makes it."""
    from repro_torch.train import step as S
    monkeypatch.setattr(S, "loss_and_grads",
                        control.gradient_doubled(S.loss_and_grads))


SERVE_FAULTS = [_state_unchanged_serve, _half_batch_serve,
                _token_altered_serve]
TRAIN_FAULTS = [_state_unchanged_train, _half_batch_train,
                _gradient_altered_train]


@pytest.mark.parametrize("workload", SERVE_CELLS)
@pytest.mark.parametrize("fault", SERVE_FAULTS, ids=lambda f: f.__name__)
def test_a_serve_fault_is_not_correct(workload, fault, monkeypatch):
    assert run_smoke(workload)["correct"]
    fault(monkeypatch)
    line = run_smoke(workload)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in line["checks"].items()
               if k != "prompt_kept")


@pytest.mark.parametrize("workload", TRAIN_CELLS)
@pytest.mark.parametrize("fault", TRAIN_FAULTS, ids=lambda f: f.__name__)
def test_a_train_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert run_smoke(workload)["correct"] is False

