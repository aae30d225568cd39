"""End-to-end training script of the port, the twin of
``examples/train_lm.py``: synthetic-data LM pretraining with the train step,
the cosine schedule (warm-up 20), asynchronous atomic checkpoints with
resume from the latest one, and the straggler monitor's hook.

``--preset tiny`` (default) is a GLM-family ~5M model, ``--preset 100m`` a
~125M-parameter one.  Re-run with the same ``--ckpt`` directory to resume
where the last checkpoint left off.  :func:`train` is the loop itself, for
callers that bring their own state and batches.

Run:  PYTHONPATH=src python -m repro_torch.train.train_lm --steps 200
      (add --device cpu to train on the CPU; --trace OUT.json writes the
      spans ``train.step`` → ``train.feed``, ``train.fwd_bwd``,
      ``train.optimizer`` as a Chrome trace, device times in ``args``)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import NamedTuple

import torch

from ..ckpt import CheckpointManager
from ..configs import get_config
from ..data.pipeline import SyntheticLM, batch_at
from ..ft import StragglerMonitor
from ..models.common import BlockSpec, ModelConfig, check_device
from ..obs import enable_tracing, save_trace, span
from ..optim.adamw import cosine_schedule
from .step import TrainState, build_train_step, make_train_state

__all__ = ["preset", "train", "main"]


def preset(name: str) -> ModelConfig:
    if name == "100m":
        return ModelConfig(name="lm-100m", vocab_size=32768, d_model=768,
                           layer_pattern=(BlockSpec(kind="attn"),),
                           n_periods=12, n_heads=12, n_kv_heads=4,
                           d_ff=2048, remat=False, dtype="float32")
    return dataclasses.replace(
        get_config("glm4_9b", reduced=True),
        name="lm-tiny", d_model=256, d_ff=512, n_periods=4, n_heads=8,
        n_kv_heads=2, head_dim=32, vocab_size=8192, dtype="float32",
        remat=False)


def train(step_fn, state: TrainState, batches, start: int, stop: int, *,
          tokens_per_step: int, mgr: CheckpointManager | None = None,
          ckpt_every: int = 0, mon: StragglerMonitor | None = None,
          log=print):
    """Steps ``start`` … ``stop`` − 1 of ``step_fn`` on ``batches(i)``,
    each timed to its end by its ``train.step`` span (``rid`` the step;
    the feed in a ``train.feed`` span; the loss is read every step); the
    time goes to ``mon`` and, every ``ckpt_every`` steps, the state to an
    asynchronous checkpoint of the step count reached.  Returns (state,
    {step: loss})."""
    losses = {}
    for i in range(start, stop):
        with span("train.step", rid=i) as sp:
            with span("train.feed"):
                batch = batches(i)
            state, metrics = step_fn(state, batch)
            losses[i] = float(metrics["loss"])
        dt = sp.duration_s
        if mon is not None:
            mon.record({0: dt})
        if i % 10 == 0 or i == stop - 1:
            log(f"step {i:4d}  loss {losses[i]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.2f}  "
                f"{tokens_per_step / dt:.0f} tok/s")
        if mgr is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, state, blocking=False)
    return state, losses


class Run(NamedTuple):
    state: TrainState
    losses: dict
    start: int


def main(argv=None) -> Run:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--preset", default="tiny", choices=("tiny", "100m"))
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="OUT.json",
                    help="record the run's spans and write them here as "
                         "Chrome trace-event JSON")
    args = ap.parse_args(argv)
    if args.trace:
        enable_tracing()

    # fp32 products stay full fp32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = preset(args.preset)
    device = check_device(args.device)
    print(f"model {cfg.name}: {cfg.n_params() / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers")

    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    lr = cosine_schedule(args.lr, warmup=20, total=args.steps)
    step_fn = build_train_step(cfg, lr=lr)
    mgr = CheckpointManager(args.ckpt, keep_n=2)
    mon = StragglerMonitor(n_hosts=1)

    start = 0
    if mgr.latest_step() is not None:
        start, state = mgr.restore(make_train_state(cfg, device="meta"),
                                   device=device)
        print(f"resumed from step {start}")
    else:
        state = make_train_state(cfg, torch.Generator(device).manual_seed(0),
                                 device)

    state, losses = train(step_fn, state,
                          lambda i: batch_at(ds, i, device), start,
                          args.steps, tokens_per_step=args.batch * args.seq,
                          mgr=mgr, ckpt_every=args.ckpt_every, mon=mon)
    mgr.wait()
    end = max(start, args.steps)
    mgr.save(end, state)
    print(f"done; checkpoints at {args.ckpt}: steps {mgr.all_steps()}")
    if args.trace:
        save_trace(args.trace)
        print(f"trace: {args.trace}")
    return Run(state, losses, start)


if __name__ == "__main__":
    main()
