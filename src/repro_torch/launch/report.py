"""The markdown report of the dry run's records (the counterpart of
``repro.launch.report``), against one H100's constants and its 80 GB.

Usage: PYTHONPATH=src python -m repro_torch.launch.report \
           --baseline results/dryrun_torch --out results/dryrun_torch.md

Every number in it is a prediction from per-device operation counts
(``launch/opcount.py``) on fake tensors, not a measurement.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import ARCH_IDS
from .cells import SHAPES, cell_is_applicable
from .roofline import CARD, HBM_BW, HBM_GB, LINK_BW, PEAK_FLOPS

__all__ = ["load", "gb_per_device", "main"]

SHORT = {
    "jamba_1_5_large_398b": "jamba-398b",
    "rwkv6_7b": "rwkv6-7b",
    "mistral_nemo_12b": "mistral-12b",
    "gemma_7b": "gemma-7b",
    "glm4_9b": "glm4-9b",
    "gemma2_9b": "gemma2-9b",
    "llama4_scout_17b_a16e": "llama4-scout",
    "deepseek_moe_16b": "dsk-moe-16b",
    "phi_3_vision_4_2b": "phi3v-4.2b",
    "whisper_base": "whisper-base",
}
MESHES = ("pod16x16", "pod2x16x16")


def load(dirname: str) -> dict:
    out = {}
    for fn in glob.glob(os.path.join(dirname, "*.json")):
        with open(fn) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"], rec["mesh"], rec.get("tag", ""))] = rec
    return out


def gb_per_device(rec) -> float:
    m = rec["memory"]
    return (m["argument_size"] + m["temp_size"] + m["output_size"]
            - m["alias_size"]) / 1e9


def _fits(rec) -> str:
    gb = gb_per_device(rec)
    return "yes" if gb <= HBM_GB else f"NO ({gb:.0f} GB)"


def _row(rec) -> str:
    rl = rec["roofline"]
    return (f"| {SHORT[rec['arch']]} | {rec['shape']} | "
            f"{gb_per_device(rec):.1f} | {rl['t_compute_s'] * 1e3:.2f} | "
            f"{rl['t_memory_s'] * 1e3:.1f} | "
            f"{rl['t_collective_s'] * 1e3:.1f} | {rl['bottleneck']} | "
            f"{rl['useful_flops_ratio']:.2f} | "
            f"{rl['roofline_fraction'] * 100:.1f}% |")


def render(base: dict) -> list[str]:
    L = []
    A = L.append
    A("# Dry run of the PyTorch port on H100 meshes\n")
    A(f"Produced by `repro_torch.launch.report` from the dry run's records. "
      f"Constants per card ({CARD}): {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 "
      f"dense, {HBM_BW / 1e12:.2f} TB/s HBM3, {LINK_BW / 1e9:.0f} GB/s "
      f"NVLink per direction, {HBM_GB:.0f} GB a card; single pod = 16×16 = "
      "256 cards, multi-pod = 2×16×16 = 512. Every number is a prediction "
      "from per-device operation counts on fake tensors, not a "
      "measurement.\n")
    A("\n## Status — every (arch × shape) on both meshes\n")
    A("| arch | shape | 16×16 | 2×16×16 | GB/dev (16×16) | fits 80 GB |")
    A("|---|---|---|---|---|---|")
    n_ok = n_skip = n_fail = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, _ = cell_is_applicable(arch, shape)
            if not ok:
                A(f"| {SHORT[arch]} | {shape} | skip | skip | — | — |")
                n_skip += 1
                continue
            recs = [base.get((arch, shape, m, "")) for m in MESHES]
            st = [r["status"] if r else "—" for r in recs]
            n_ok += st.count("ok")
            n_fail += st.count("fail")
            r1 = recs[0]
            good = r1 is not None and r1["status"] == "ok"
            A(f"| {SHORT[arch]} | {shape} | {st[0]} | {st[1]} | "
              f"{f'{gb_per_device(r1):.1f}' if good else '—'} | "
              f"{_fits(r1) if good else '—'} |")
    A(f"\n**{n_ok} traced ok; {n_skip} documented skips; {n_fail} "
      "failures.**\n")
    A("\n## Roofline terms, single pod\n")
    A(f"`Tc = FLOPs/(256·{PEAK_FLOPS:.3g})`, `Tm = bytes/(256·"
      f"{HBM_BW:.3g})`, `Tx = collective_bytes/(256·{LINK_BW:.3g})`; "
      "`useful` = model FLOPs (6·N_active·D train, 2·N_active·D prefill, "
      "2·N_active·B decode) ÷ counted FLOPs; `roofline` = useful FLOPs at "
      "max(Tc, Tm, Tx) ÷ peak.\n")
    A("| arch | shape | GB/dev | Tc ms | Tm ms | Tx ms | bottleneck | "
      "useful | roofline |")
    A("|---|---|---|---|---|---|---|---|---|")
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = base.get((arch, shape, "pod16x16", ""))
            if r and r.get("status") == "ok":
                A(_row(r))
    return L


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/dryrun_torch.md")
    args = ap.parse_args(argv)
    L = render(load(args.baseline))
    with open(args.out, "w") as f:
        f.write("\n".join(L) + "\n")
    print(f"wrote {args.out} ({len(L)} lines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
