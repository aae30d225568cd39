"""The control, the reference put in the program's place at the nearest
precision below bf16 (every product's operands rounded to fp8 e4m3), is
not correct: at the smoke sizes on the CPU, and on a card at each cell's
own size on three seeds (``bench/control.py`` gives the same readings
for the limits' tables)."""

from __future__ import annotations

import pytest
import torch

from benchlib import ROOT, SERVE_CELLS, TRAIN_CELLS

from bench import control, harness

# smoke seeds whose control readings stand clear of the smoke limits
SMOKE_SEEDS = {"nemo_serve": 20, "rwkv6_train": 16}
FULL_SEEDS = (4300000001, 4300000002, 4300000003)
# calls a 30 s window holds on an H100: the sample is drawn from them
CALLS = {"nemo_serve": 10}


def _serve(workload, seed, smoke, device, calls):
    cell = harness.load_cell(ROOT, workload, seed, 0.0, False, device, smoke)
    return control.serve_readings(cell, calls, control=True), cell.limits


def _serve_fails(r, limits):
    over = [k for k in limits if r["control"][k] > limits[k]]
    within = all(r[k] <= limits[k] for k in limits)
    return over, within


def _train(workload, seed, smoke, device):
    cell = harness.load_cell(ROOT, workload, seed, 0.0, False, device, smoke)
    return (control.train_readings(cell, control=True, faults=smoke),
            cell.limits)


def _train_fails(r, limits):
    over = [k for k in limits if r["control"][k] > limits[k]]
    within = all(r["program"][k] <= limits[k] for k in limits)
    return over, within


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serve_control_is_not_correct_smoke(workload):
    r, limits = _serve(workload, SMOKE_SEEDS[workload], True, "cpu", 8)
    over, within = _serve_fails(r, limits)
    assert over and within


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_control_is_not_correct_smoke(workload):
    r, limits = _train(workload, SMOKE_SEEDS[workload], True, "cpu")
    over, within = _train_fails(r, limits)
    assert over and within


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serve_control_is_not_correct_on_the_card(workload):
    _card()
    for seed in FULL_SEEDS:
        r, limits = _serve(workload, seed, False, "cuda", CALLS[workload])
        over, within = _serve_fails(r, limits)
        assert over and within, (seed, r)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_control_is_not_correct_on_the_card(workload):
    _card()
    for seed in FULL_SEEDS:
        r, limits = _train(workload, seed, False, "cuda")
        over, within = _train_fails(r, limits)
        assert over and within, (seed, r)
