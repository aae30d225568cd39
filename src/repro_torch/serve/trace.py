"""Synthetic serving-traffic traces (the serving simulator's input): a copy
of the reference's ``repro.serve.trace``.

A :class:`TraceSpec` describes a traffic mix declaratively — Poisson
arrivals at ``rate`` requests/s, mixed prompt/output length distributions,
and multi-model tenancy weights over ``repro_torch.configs`` ids — and
:func:`generate_trace` expands it into a deterministic, seeded list of
:class:`Request`\\ s.  Everything downstream (admission, batching, KV
pressure, SLO scoring in :mod:`repro_torch.serve.sim`) is a pure function of this
list plus the candidate design, so two runs of the same spec are
bit-identical and a spec string is a complete provenance record of the
workload.

The spec grammar (the reference CLI's ``--trace-spec``) is a comma list of
``key=value`` items::

    seed=0,requests=64,rate=0.25,models=gemma_7b:2;rwkv6_7b:1,
    prompt=64:256,output=16:64

``models`` maps config ids to tenancy weights (``;``-separated); ``prompt``
and ``output`` are ``mean:max`` token-length pairs.  Lengths are drawn from
a clipped exponential (the long-tail shape of real serving logs), arrivals
from the exponential interarrival process, model identity from the
normalized weights.  The golden snapshot ``tests/golden/tiny_trace.json``
pins the seed-0 output of the default spec.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

__all__ = ["TraceSpec", "Request", "parse_trace_spec", "generate_trace",
           "trace_as_dicts", "trace_from_dicts", "save_trace_json",
           "DEFAULT_TRACE_SPEC"]


@dataclass(frozen=True)
class Request:
    """One serving request: arrives at ``arrival_ms``, carries a ``prompt``
    -token prefill and asks for ``output`` generated tokens from ``model``."""

    rid: int
    arrival_ms: float
    model: str
    prompt: int
    output: int

    def as_dict(self) -> dict:
        return {"rid": self.rid, "arrival_ms": self.arrival_ms,
                "model": self.model, "prompt": self.prompt,
                "output": self.output}

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        return cls(rid=int(d["rid"]), arrival_ms=float(d["arrival_ms"]),
                   model=str(d["model"]), prompt=int(d["prompt"]),
                   output=int(d["output"]))


@dataclass(frozen=True)
class TraceSpec:
    """Declarative description of one synthetic traffic mix."""

    seed: int = 0
    requests: int = 64
    rate_rps: float = 0.25            # mean Poisson arrival rate, requests/s
    models: tuple[tuple[str, float], ...] = (("gemma_7b", 1.0),)
    prompt_mean: int = 64
    prompt_max: int = 256
    output_mean: int = 16
    output_max: int = 64

    def __post_init__(self):
        if self.requests < 0:
            raise ValueError(f"requests must be >= 0, got {self.requests}")
        if self.rate_rps <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate_rps}")
        if not self.models:
            raise ValueError("trace spec needs at least one model")
        if any(w <= 0 for _, w in self.models):
            raise ValueError(f"model weights must be > 0: {self.models}")
        for mean, mx, what in ((self.prompt_mean, self.prompt_max, "prompt"),
                               (self.output_mean, self.output_max, "output")):
            if not (1 <= mean <= mx):
                raise ValueError(
                    f"{what} lengths need 1 <= mean <= max, got "
                    f"mean={mean} max={mx}")

    def spec(self) -> str:
        """Canonical spec string — ``parse_trace_spec(s.spec()) == s``."""
        models = ";".join(f"{m}:{w:g}" for m, w in self.models)
        return (f"seed={self.seed},requests={self.requests},"
                f"rate={self.rate_rps:g},models={models},"
                f"prompt={self.prompt_mean}:{self.prompt_max},"
                f"output={self.output_mean}:{self.output_max}")

    def as_dict(self) -> dict:
        return {"seed": self.seed, "requests": self.requests,
                "rate_rps": self.rate_rps,
                "models": {m: w for m, w in self.models},
                "prompt": [self.prompt_mean, self.prompt_max],
                "output": [self.output_mean, self.output_max],
                "spec": self.spec()}


DEFAULT_TRACE_SPEC = TraceSpec()


def _int_pair(val: str, what: str) -> tuple[int, int]:
    parts = val.split(":")
    if len(parts) != 2:
        raise ValueError(f"{what} expects 'mean:max', got {val!r}")
    try:
        return int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"{what} expects integers, got {val!r}") from None


def parse_trace_spec(text: str, default_models=None) -> TraceSpec:
    """``key=value`` comma list → :class:`TraceSpec` (see module docstring).

    ``default_models`` supplies the tenancy mix (equal weights) when the
    spec string does not name one — the CLI passes the swept config ids so
    ``--objective serving`` defaults to multi-model tenancy over the zoo.
    """
    kw: dict = {}
    for item in filter(None, (t.strip() for t in text.split(","))):
        if "=" not in item:
            raise ValueError(f"trace spec item {item!r} is not key=value")
        key, val = item.split("=", 1)
        key, val = key.strip(), val.strip()
        if key == "seed":
            kw["seed"] = int(val)
        elif key == "requests":
            kw["requests"] = int(val)
        elif key == "rate":
            kw["rate_rps"] = float(val)
        elif key == "models":
            mix = []
            for part in filter(None, val.split(";")):
                name, _, w = part.partition(":")
                mix.append((name.strip(), float(w) if w else 1.0))
            kw["models"] = tuple(mix)
        elif key == "prompt":
            kw["prompt_mean"], kw["prompt_max"] = _int_pair(val, "prompt")
        elif key == "output":
            kw["output_mean"], kw["output_max"] = _int_pair(val, "output")
        else:
            raise ValueError(
                f"unknown trace-spec key {key!r} (known: seed, requests, "
                f"rate, models, prompt, output)")
    if "models" not in kw and default_models:
        kw["models"] = tuple((m, 1.0) for m in default_models)
    return TraceSpec(**kw)


def _clipped_exp_length(rng: np.random.Generator, mean: int, mx: int) -> int:
    """1 + Exp(mean-1) clipped to [1, mx] — a long-tailed token length."""
    if mean <= 1:
        return 1
    draw = 1 + int(rng.exponential(mean - 1))
    return min(draw, mx)


def generate_trace(spec: TraceSpec) -> list[Request]:
    """Expand ``spec`` into a deterministic arrival-ordered request list.

    Seeded PCG64 stream; arrival times are rounded to 1 µs so the JSON
    round trip (golden snapshot, bench artifacts) is exact.
    """
    rng = np.random.default_rng(spec.seed)
    weights = np.array([w for _, w in spec.models], dtype=float)
    cum = np.cumsum(weights / weights.sum())
    names = [m for m, _ in spec.models]
    out: list[Request] = []
    t = 0.0
    for rid in range(spec.requests):
        t += float(rng.exponential(1000.0 / spec.rate_rps))
        pick = names[int(np.searchsorted(cum, rng.random(), side="right"))
                     if len(names) > 1 else 0]
        prompt = _clipped_exp_length(rng, spec.prompt_mean, spec.prompt_max)
        output = _clipped_exp_length(rng, spec.output_mean, spec.output_max)
        out.append(Request(rid=rid, arrival_ms=round(t, 3), model=pick,
                           prompt=prompt, output=output))
    return out


def trace_as_dicts(trace: list[Request]) -> list[dict]:
    return [r.as_dict() for r in trace]


def trace_from_dicts(rows: list[dict]) -> list[Request]:
    return [Request.from_dict(d) for d in rows]


def save_trace_json(path: str, spec: TraceSpec,
                    trace: list[Request]) -> None:
    """Golden-snapshot writer (``tests/golden/tiny_trace.json``)."""
    with open(path, "w") as f:
        json.dump({"spec": spec.spec(), "requests": trace_as_dicts(trace)},
                  f, indent=1)
        f.write("\n")
