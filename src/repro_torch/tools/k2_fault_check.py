"""How the bf16 K2 checks see a sound kernel and a faulty one.

Copies ``repro_torch`` (without its build directory) once per variant into a
temporary directory and plants a fault in the copy's
``csrc/flash_attention.cu`` (the checkout's own files are never changed):

  * ``sound``      — no change;
  * ``skip_tile``  — prefill: a q tile with 12 or more kv tiles skips the
    6th (the ring's barriers still turn over, only its softmax and P·V are
    left out);
  * ``late_rows``  — prefill: rows at or past Tq/2 are stored 10% too
    large;
  * ``skip_split`` — decode: the combine leaves out the partial of split
    splits/2;
  * ``stale_max``  — decode: the combine merges the last split's partial
    without its e^(m_i - M) rescale.

Each copy builds its library and runs, at the main paths' prefill shapes
(Whisper's cross step is also the Tq = 1 over 1500 keys edge case) and
decode shapes (``tools/k2_ab.py``'s), the kernel picked by
``ops.flash_attention`` / ``ops.decode_attention`` against both
yardsticks: the 3e-2 gate against the bf16 plain version and
``ref.attention_rel_err`` (fp32 plain version, relative to |want| plus the
row's rms).  Prints one JSON line per variant and shape.  Needs the card:

    PYTHONPATH=src python -m repro_torch.tools.k2_fault_check
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BF16_TOL = 3e-2
BF16_REL_TOL = 3 * 2.0 ** -7

SKIP_ANCHOR = "    // S = Q K^T: D/16 steps of k16, K-major operands\n"
SKIP_FAULT = """    if (i == 5 && n_tiles >= 12) {
      mbar_wait(k_full(s), parity);
      mbar_wait(v_full(s), parity);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      continue;
    }
"""
LATE_ANCHOR = "    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);\n"
LATE_FAULT = ("    const float inv = (row + 8 * r >= Tq / 2 ? 1.1f : 1.f) /\n"
              "                      (l[r] == 0.f ? 1.f : l[r]);\n")
W_ANCHOR = "    const float ci = exp2f(w_sm[i] - mx);\n"
VARIANTS = {   # variant: the (anchor, replacement) pairs it plants
    "sound": (),
    "skip_tile": ((SKIP_ANCHOR, SKIP_FAULT + SKIP_ANCHOR),),
    "late_rows": ((LATE_ANCHOR, LATE_FAULT),),
    "skip_split": ((W_ANCHOR, "    const float ci = i == splits / 2 ? 0.f : "
                    "exp2f(w_sm[i] - mx);\n"),),
    "stale_max": ((W_ANCHOR, "    const float ci = i == splits - 1 ? 1.f : "
                   "exp2f(w_sm[i] - mx);\n"),),
}


def plant(variant: str, work: Path) -> Path:
    """A copy of the package with the variant's fault under ``work``;
    returns the directory to put on ``PYTHONPATH``."""
    root = work / variant
    shutil.copytree(PKG, root / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = root / "repro_torch" / "csrc" / "flash_attention.cu"
    code = src.read_text()
    for anchor, text in VARIANTS[variant]:
        if code.count(anchor) != 1:
            raise RuntimeError(f"{variant}: anchor not found once in {src}")
        code = code.replace(anchor, text)
    src.write_text(code)
    return root


def measure(variant: str) -> None:
    """Runs in a copy: each shape's readings, one JSON line each."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import (decode_attention_cuda,
                                                     flash_attention_cuda)
    from repro_torch.tools.k2_ab import DECODE_SHAPES, SHAPES

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    for name, B, Hq, Hkv, Tq, Tk, D, causal in SHAPES:
        q = torch.randn((B, Hq, Tq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, Tk, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        before = flash_attention_cuda.tensor_core_launches
        got = ops.flash_attention(q, k, v, causal=causal)
        want = R.attention_ref(q, k, v, causal=causal).float()
        diff = (got.float() - want).abs()
        excess = (diff - BF16_TOL * want.abs()).max().item()
        rel = R.attention_rel_err(got, q, k, v, causal=causal)
        print(json.dumps({
            "variant": variant, "shape": name,
            "tensor_core": flash_attention_cuda.tensor_core_launches - before,
            "max_abs_err": diff.max().item(),
            "median_abs_want": want.abs().median().item(),
            "gate_3e-2": "pass" if excess <= BF16_TOL else "fail",
            "rel_err": rel,
            "gate_rel": "pass" if rel <= BF16_REL_TOL else "fail"}),
            flush=True)
    for name, B, Hq, Hkv, S, D, pos, window in DECODE_SHAPES:
        q = torch.randn((B, Hq, 1, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, S, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        before = decode_attention_cuda.split_launches
        got = ops.decode_attention(q, k, v, pos=pos_t, window=window)
        want = R.decode_attention_ref(q, k, v, pos=pos,
                                      window=window).float()
        diff = (got.float() - want).abs()
        excess = (diff - BF16_TOL * want.abs()).max().item()
        rel = R.attention_rel_err(got, q, k, v, causal=True, offset=pos,
                                  window=window)
        print(json.dumps({
            "variant": variant, "shape": f"decode {name}",
            "split": decode_attention_cuda.split_launches - before,
            "max_abs_err": diff.max().item(),
            "median_abs_want": want.abs().median().item(),
            "gate_3e-2": "pass" if excess <= BF16_TOL else "fail",
            "rel_err": rel,
            "gate_rel": "pass" if rel <= BF16_REL_TOL else "fail"}),
            flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return 0
    rc = 0
    with tempfile.TemporaryDirectory(prefix="k2_faults_") as work:
        procs = {}
        for variant in VARIANTS:
            env = dict(os.environ, PYTHONPATH=str(plant(variant, Path(work))))
            procs[variant] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.tools.k2_fault_check",
                 "--measure", variant], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for variant, proc in procs.items():
            out = proc.communicate()[0]
            print(out, end="", flush=True)
            if proc.returncode:
                print(f"{variant}: exit {proc.returncode}", flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
