"""One rank of ``tests/test_torch_sharded.py``'s 2×2 ``gloo`` mesh (torch
only, so the spawned ranks import no jax).

Every rank gets the same numpy inputs (parameters converted from the
reference, tokens, a batch, the MoE block's inputs), lays the parameters
out by the sharding rules and runs the port's sharded paths; rank 0 writes
the full results to an npz file for the test to hold against ``repro``.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


def _to_np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _dense(job, mesh, out):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import build_serve_step
    from repro_torch.train.step import (build_train_step, loss_and_grads,
                                        make_train_state)

    cfg = dataclasses.replace(get_config(job["arch"], reduced=True),
                              **job["over"])
    params = params_from_jax(job["params"], cfg, device="cpu")
    tokens = torch.from_numpy(job["tokens"])

    # the forward
    logits, _ = TF.forward(params, tokens, cfg, backend="ref", mesh=mesh)
    out["forward"] = _to_np(logits)

    # every decode step of generate, teacher-forced prompt then greedy
    prompts = torch.from_numpy(job["prompts"])
    Bsz, Tp = prompts.shape
    state = TF.init_decode_state(cfg, Bsz, Tp + job["max_new"], "cpu")
    step, dparams, state = build_serve_step(cfg, "ref", mesh).jit_with(
        params, state)
    out["cache_placements"] = np.array(
        [str(p) for p in state["pos0"]["k"].placements])
    pos = torch.zeros((), dtype=torch.int32)
    steps, tok = [], None
    for t in range(Tp + job["max_new"] - 1):
        tok = prompts[:, t] if t < Tp else tok
        lg, state = step(dparams, state, tok, pos)
        pos += 1
        steps.append(_to_np(lg))
        tok = torch.from_numpy(steps[-1].argmax(-1).astype(np.int32))
    out["decode"] = np.stack(steps)

    # the loss and its gradients, then one train step
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    state = make_train_state(cfg, device="cpu")
    state = state._replace(params=params)
    tstep, dstate = build_train_step(cfg, mesh, lr=1e-3).jit_with(state)
    loss, _, grads = loss_and_grads(cfg, dstate.params, batch, mesh=mesh)
    out["loss"] = _to_np(loss)
    for path, g in _paths(grads):
        out[f"grad/{path}"] = _to_np(g)
    _, metrics = tstep(dstate, batch)
    out["step_loss"] = _to_np(metrics["loss"])
    out["step_grad_norm"] = _to_np(metrics["grad_norm"])


def _moe(job, mesh, out):
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as B
    from repro_torch.parallel.sharding import (distribute, distribute_tree,
                                               shard_params_spec)

    cfg = dataclasses.replace(get_config(job["moe_arch"], reduced=True),
                              **job["moe_over"])
    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        return torch.from_numpy(np.asarray(t))

    p = tensors(job["moe_p"])
    x = torch.from_numpy(job["moe_x"])
    dp = distribute_tree(p, shard_params_spec(p, mesh), mesh)
    y, aux = B.moe_fwd(cfg, dp, distribute(
        x, mesh, ("batch", "none", "none")), mesh)
    out["moe_y"] = _to_np(y)
    out["moe_aux"] = _to_np(aux)
    y1, aux1 = B.moe_fwd(cfg, p, x)      # unsharded: capacity over all tokens
    out["moe_y_unsharded"] = _to_np(y1)


def run(rank: int, store_path: str, job: dict, out_path: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out: dict = {}
        _dense(job, mesh, out)
        _moe(job, mesh, out)
        if rank == 0:
            np.savez(out_path + ".tmp.npz", **out)
            os.replace(out_path + ".tmp.npz", out_path)
    finally:
        dist.destroy_process_group()
