"""Minimal, deterministic VCD (IEEE 1364 value-change-dump) writer.

:mod:`repro_torch.core.rtlsim` executes the emitted netlist with float64 value
streams, one per DAG node; this writer turns those streams into a waveform
file any viewer loads (GTKWave: ``gtkwave out.vcd``; Surfer and WaveTrace
work too).  Signals are declared as ``real`` vars — the simulation is
behavioral-numeric, not bit-level — under one ``$scope`` per design.

The output is **deterministic**: no ``$date``/``$version`` headers, signal
id codes assigned in registration order, and per-timestep change records in
registration order — so a golden-snapshot test can diff the file byte for
byte.

Multi-stage simulations (:func:`repro_torch.core.rtlsim.simulate_rtl_stages`)
share one writer: :meth:`advance` moves the time origin past the finished
stage, so both stages land on one monotonic timeline.
"""

from __future__ import annotations

import math
import os

__all__ = ["VCDWriter"]

# VCD identifier alphabet: printable ASCII '!'..'~'
_ID0 = 33
_IDN = 94


def _idcode(i: int) -> str:
    s = ""
    while True:
        s = chr(_ID0 + i % _IDN) + s
        i = i // _IDN - 1
        if i < 0:
            return s


class VCDWriter:
    """Collects real-valued signal streams and renders one VCD file (the
    reference's text; NumPy, imported on first use, finds a stream's
    changes and orders the records)."""

    def __init__(self, path: str | None = None, design: str = "design",
                 timescale: str = "1ns"):
        self.path = path
        self.design = design
        self.timescale = timescale
        self._vars: list[tuple[str, str]] = []   # (idcode, name)
        self._by_name: dict[str, str] = {}
        # change records in recording order: (times, idcode, values)
        self._chunks: list[tuple] = []
        self._offset = 0
        self._t_end = 0

    # -- declaration -------------------------------------------------------
    def add_signal(self, name: str) -> str:
        """Register a real-valued signal; returns its id code.  Re-adding a
        name returns the existing code (stages share declarations)."""
        code = self._by_name.get(name)
        if code is None:
            code = _idcode(len(self._vars))
            self._vars.append((code, name))
            self._by_name[name] = code
        return code

    # -- recording ---------------------------------------------------------
    def record(self, t: int, code: str, value: float) -> None:
        """One change record at stage-local time ``t`` (offset applied)."""
        self._add([int(t)], code, [float(value)])

    def dump_stream(self, name: str, values) -> None:
        """Record a full per-cycle value stream, change-compressed: the
        value at ``t=0`` is always dumped, later cycles only on change."""
        import numpy as np
        code = self.add_signal(name)
        v = np.asarray(values, dtype=np.float64).ravel()
        keep = np.ones(v.size, dtype=bool)
        keep[1:] = v[1:] != v[:-1]     # NaN != NaN: a change, as in Python
        self._add(np.flatnonzero(keep), code, v[keep])

    def _add(self, times, code: str, values) -> None:
        import numpy as np
        t = np.asarray(times, dtype=np.int64) + self._offset
        if t.size:
            self._chunks.append((t, code, np.asarray(values, np.float64)))
            self._t_end = max(self._t_end, int(t.max()) + 1)

    def advance(self, cycles: int) -> None:
        """Move the time origin forward (stage handover)."""
        self._offset += int(cycles)
        if self._offset > self._t_end:
            self._t_end = self._offset

    # -- rendering ---------------------------------------------------------
    @staticmethod
    def _fmt(v: float) -> str:
        if math.isnan(v):
            return "rnan"
        return f"r{v:.17g}"

    def render(self) -> str:
        """The complete VCD text (header + sorted change records)."""
        # the header names the reference's simulator, as the reference's
        # writer does, so the two dumps compare byte for byte
        lines = [
            f"$comment repro.core.rtlsim waveform — design {self.design!r} "
            f"$end",
            f"$timescale {self.timescale} $end",
            f"$scope module {_vcd_ident(self.design)} $end",
        ]
        for code, name in self._vars:
            lines.append(f"$var real 64 {code} {_vcd_ident(name)} $end")
        lines += ["$upscope $end", "$enddefinitions $end"]
        if self._chunks:
            lines += self._records()
        lines.append(f"#{self._t_end}")
        return "\n".join(lines) + "\n"

    def _records(self) -> list[str]:
        """Every ``#t`` marker and change record: times ascending, records
        of one time in recording order; each distinct value (bit pattern,
        so ``-0`` stays apart from ``0``) formatted once."""
        import numpy as np
        chunks = self._chunks
        t = np.concatenate([c[0] for c in chunks])
        v = np.concatenate([c[2] for c in chunks])
        ci = np.repeat(np.arange(len(chunks)), [len(c[0]) for c in chunks])
        order = np.argsort(t, kind="stable")
        t, v, ci = t[order], v[order], ci[order]
        bits, inv = np.unique(v.view(np.int64), return_inverse=True)
        fmt = [self._fmt(x) for x in bits.view(np.float64).tolist()]
        codes = [c[1] for c in chunks]
        recs = [f"{fmt[u]} {codes[c]}"
                for u, c in zip(inv.ravel().tolist(), ci.tolist())]
        starts = np.flatnonzero(np.r_[True, t[1:] != t[:-1]]).tolist()
        out: list[str] = []
        for s, e in zip(starts, starts[1:] + [len(recs)]):
            out.append(f"#{int(t[s])}")
            out += recs[s:e]
        return out

    def save(self, path: str | None = None) -> str:
        """Write :meth:`render` to ``path`` (or the constructor path);
        returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("VCDWriter has no output path")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.render())
        return path

    @property
    def n_signals(self) -> int:
        return len(self._vars)


def _vcd_ident(name: str) -> str:
    """Identifiers GTKWave accepts: no whitespace/brackets."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch in "_.$-" else "_")
    return "".join(out) or "_"
