"""Shared helpers of the generator's parity tests (tests/test_torch_generator.py,
tests/test_torch_rtlsim.py): the paper's fused 256-FU designs built by the
reference (``benchmarks.designs``) and, from the same loops, by the port,
and a structural normal form to compare the two packages' objects by."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

import repro_torch.core.workload as PW
from benchmarks.designs import DESIGNS
from repro.core.adg import generate_adg as ref_generate_adg
from repro.core.dag import codegen as ref_codegen
from repro.core.passes import run_backend as ref_run_backend
from repro_torch.core.adg import generate_adg
from repro_torch.core.dag import codegen
from repro_torch.core.dataflow import build_dataflow
from repro_torch.core.passes import run_backend

FUSED = ("GEMM-MJ", "Conv2d-MNICOC", "MTTKRP-MJ", "Attention")


def norm(x):
    """A plain structure (dicts, lists, ints, floats, strings) for any of
    the generator's objects, so the reference's and the port's compare with
    ``==`` whatever their classes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"<class>": type(x).__name__,
                **{f.name: norm(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {norm_key(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(norm(v) for v in x)
    if isinstance(x, np.ndarray):
        return {"<array>": str(x.dtype), "v": x.tolist()}
    if isinstance(x, torch.Tensor):
        return {"<array>": str(x.dtype).replace("torch.", ""),
                "v": x.cpu().tolist()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def norm_key(k):
    if isinstance(k, tuple):
        return tuple(norm_key(v) for v in k)
    if isinstance(k, np.generic):
        return k.item()
    return k


def dag_form(dag) -> dict:
    """Every node, edge and provenance table of a DAG."""
    return {
        "name": dag.name, "next": dag._next,
        "nodes": norm(dag.nodes), "edges": norm(dag.edges),
        "users": norm(dag.users), "dataflows": list(dag.dataflows),
        "opnd_ports": norm(dag.opnd_ports),
        "fu_product": norm(dag.fu_product),
        "workloads": list(dag.workloads),
        "df_workload": dict(dag.df_workload), "sched": norm(dag.sched),
    }


def port_spec(wl, df):
    """The port's (workload, dataflow) with the reference's loops."""
    pwl = getattr(PW, wl.name)()
    pdf = build_dataflow(pwl, spatial=[(l.dim, l.size) for l in df.spatial],
                         temporal=[(l.dim, l.size) for l in df.temporal],
                         c=tuple(int(v) for v in df.c), name=df.name)
    return pwl, pdf


@functools.lru_cache(maxsize=None)
def fused_pair(name: str):
    """(reference ADG, DAG, report), (port ADG, DAG, report) of one of the
    paper's fused designs, each DAG through the optimizing back end."""
    specs = DESIGNS[name]()
    radg = ref_generate_adg(specs, name=name)
    rdag = ref_codegen(radg)
    rrep = ref_run_backend(rdag)
    padg = generate_adg([port_spec(w, d) for w, d in specs], name=name)
    pdag = codegen(padg)
    prep = run_backend(pdag)
    return (radg, rdag, rrep), (padg, pdag, prep)


def int_inputs(wl, sizes, seed=0) -> dict[str, np.ndarray]:
    """Integer-valued float64 operands, as tests/test_backend.py draws
    them (any summation order is exact on them)."""
    r = np.random.default_rng(seed)
    return {t.name: r.integers(-4, 5, size=wl.tensor_shape(t, sizes))
            .astype(np.float64) for t in wl.inputs}


def attention_inputs(adg, seed=0) -> dict[str, np.ndarray]:
    r = np.random.default_rng(seed)
    qk, pv = adg.spec("attn-qk"), adg.spec("attn-pv")
    out = {}
    for spec, names in ((qk, ("Q", "K")), (pv, ("V",))):
        sizes = spec.dataflow.sizes()
        for name in names:
            shape = spec.workload.tensor_shape(spec.workload.tensor(name),
                                               sizes)
            out[name] = r.integers(-4, 5, size=shape).astype(np.float64)
    return out


def to_torch(inputs: dict, device="cpu") -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
