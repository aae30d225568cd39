"""Shared helpers of the paper-evaluation parity tests
(tests/test_torch_paper_figures.py, tests/test_torch_paper_tables.py): one
function of the reference's ``benchmarks/run.py`` and its twin in
``repro_torch.paper_figures`` run in this process with their standard
output captured, the port's on the CPU, and their rows in a form where
only the timings are masked."""

from __future__ import annotations

import contextlib
import io

import benchmarks.run as RR
import repro_torch.core.passes as PP
import repro_torch.paper_figures as PF

# the rows' fields that time something; every other field is compared as
# the string printed ("speedup" times something only in the micro rows)
TIMING = frozenset({"gen_time_s", "unmemoized_us", "memoized_us",
                    "scalar_us", "batched_us", "gflops"})

# the functions each file compares, split so that each file takes about
# as long as the other (~150 s on one worker): the figures that generate
# and cost designs on the host and the micro-benchmarks; the tables, and
# the rows that map networks (Fig. 11, the instruction overhead)
FIGURES = ("fig10_backend_opts", "fig12_breakdown",
           "fig13_14_backend_breakdown", "mapper_micro",
           "mapper_batch_micro", "kernel_micro")
TABLES = ("fig11_e2e", "table2_genai", "table3_handwritten",
          "table4_scaling", "table5_fusion", "table6_related",
          "instr_overhead")

# run_backend calls a function makes (each design, each back-end mode)
BACKENDS = {"fig10_backend_opts": 18, "fig12_breakdown": 1,
            "table3_handwritten": 2, "table4_scaling": 4,
            "table5_fusion": 4, "table6_related": 1}


def rows(text: str) -> list[tuple[str, list[str]]]:
    """``(name, fields)`` for every ``name,us_per_call,derived`` row, the
    timing fields masked; ``us_per_call`` must be an integer."""
    out = []
    for line in text.splitlines():
        name, us, derived = line.split(",", 2)
        assert us.isdigit(), line
        fields = []
        for f in derived.split(";"):
            key = f.split("=", 1)[0]
            if key in TIMING or (key == "speedup"
                                 and name.startswith("micro.")):
                f = f"{key}=<t>"
            fields.append(f)
        out.append((name, fields))
    return out


def reference_rows(name: str) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        getattr(RR, name)()
    return rows(buf.getvalue())


def port_rows(name: str, monkeypatch) -> tuple[list, list]:
    """The port's function on the CPU: its rows, and the FIFO-chain LP
    terms (``passes._chain_fifo_terms``) of the DAG after each of its
    ``run_backend`` calls."""
    terms = []
    real = PP.run_backend

    def recording(dag, *args, **kwargs):
        out = real(dag, *args, **kwargs)
        terms.append(PP._chain_fifo_terms(dag))
        return out

    monkeypatch.setattr(PP, "run_backend", recording)
    fn = getattr(PF, name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn("cpu") if fn in PF.ON_DEVICE else fn()
    return rows(buf.getvalue()), terms


def check_function(name: str, monkeypatch) -> None:
    """The port's rows equal the reference's, names in order and every
    field but the timings as printed, and no design it builds has a FIFO
    fed by a FIFO (so none takes the port's extra LP rows)."""
    want = reference_rows(name)
    got, terms = port_rows(name, monkeypatch)
    assert got == want
    assert len(terms) == BACKENDS.get(name, 0)
    assert not any(terms), terms
