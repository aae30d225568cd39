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
    """Collects real-valued signal streams and renders one VCD file."""

    def __init__(self, path: str | None = None, design: str = "design",
                 timescale: str = "1ns"):
        self.path = path
        self.design = design
        self.timescale = timescale
        self._vars: list[tuple[str, str]] = []   # (idcode, name)
        self._by_name: dict[str, str] = {}
        self._changes: dict[int, list[tuple[str, float]]] = {}
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
        t = int(t) + self._offset
        self._changes.setdefault(t, []).append((code, float(value)))
        if t + 1 > self._t_end:
            self._t_end = t + 1

    def dump_stream(self, name: str, values) -> None:
        """Record a full per-cycle value stream, change-compressed: the
        value at ``t=0`` is always dumped, later cycles only on change."""
        code = self.add_signal(name)
        prev = None
        for t, v in enumerate(values):
            v = float(v)
            if prev is None or v != prev:
                self.record(t, code, v)
                prev = v

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
        for t in sorted(self._changes):
            lines.append(f"#{t}")
            for code, v in self._changes[t]:
                lines.append(f"{self._fmt(v)} {code}")
        lines.append(f"#{self._t_end}")
        return "\n".join(lines) + "\n"

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
