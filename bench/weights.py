"""The benchmark's weights: drawn from ``--seed`` on the run's device, in
the model's dtype, one generator call a leaf of the program's parameter
tree (stacked over layers, so a dozen calls a model).

Each leaf has a seed of its own, mixed from the run's seed and the leaf's
key path, so that any leaf can be drawn again alone (the train cells
regenerate the starting weights for their checks).  How a leaf is drawn
is the architecture's rule (``bench/arch/<name>.py``, ``weight_init``).
"""

from __future__ import annotations

import hashlib

import torch


def leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key path, leaf) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += paths(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def set_path(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def draw(arch, seed: int, path: str, shape, dtype, device) -> torch.Tensor:
    kind, v = arch.weight_init(path.split("/")[-1], tuple(shape))
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, path))
    out = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)
    if kind == "normal":
        return out.mul_(v)
    if kind == "decay":                  # -4 + v·N(0, 1)
        return out.mul_(v).sub_(4.0)
    raise ValueError(f"unknown weight rule {kind!r} for {path}")


def template(cfg) -> dict:
    """The program's parameter tree of ``cfg``, shapes and dtypes only."""
    from repro_torch.models import transformer as TF
    return TF.init_params(cfg, device="meta")


def make(arch, cfg, seed: int, device) -> dict:
    """Every weight of ``cfg``'s tree, drawn from ``seed``."""
    tree: dict = {}
    for path, meta in paths(template(cfg)):
        set_path(tree, path, draw(arch, seed, path, meta.shape, meta.dtype,
                                  device))
    return tree
