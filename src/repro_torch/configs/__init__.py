"""Architecture registry of the PyTorch port: the same ids and aliases as
``repro.configs``, with ``full()`` / ``smoke()`` copies of every config:
the dense LMs, RWKV-6, the Jamba hybrid (Mamba + attention + MoE), the two
MoE LMs, the vision-prefix LM (Phi-3-vision, served by
``models/transformer.py`` with ``prefix_embeds``) and the encoder-decoder
(Whisper, served by ``models/encdec.py``)."""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "jamba_1_5_large_398b",
    "rwkv6_7b",
    "mistral_nemo_12b",
    "gemma_7b",
    "glm4_9b",
    "gemma2_9b",
    "llama4_scout_17b_a16e",
    "deepseek_moe_16b",
    "phi_3_vision_4_2b",
    "whisper_base",
]

# ids whose config module and model blocks exist in the port
PORTED_IDS = ["mistral_nemo_12b", "gemma_7b", "glm4_9b", "gemma2_9b",
              "rwkv6_7b", "jamba_1_5_large_398b", "deepseek_moe_16b",
              "llama4_scout_17b_a16e", "phi_3_vision_4_2b", "whisper_base"]

# CLI aliases (--arch uses dashed ids)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "rwkv6-7b": "rwkv6_7b",
    "gemma-7b": "gemma_7b",
    "gemma2-9b": "gemma2_9b",
    "glm4-9b": "glm4_9b",
    "whisper-base": "whisper_base",
    "llama": "llama4_scout_17b_a16e",   # family shorthand for the CLIs
    "llama4": "llama4_scout_17b_a16e",
})


def get_config(name: str, reduced: bool = False):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown config id {name!r}; known: "
                       f"{', '.join(ARCH_IDS)}")
    if mod_name not in PORTED_IDS:
        raise NotImplementedError(
            f"{mod_name} is not yet ported to repro_torch; ported: "
            f"{', '.join(PORTED_IDS)}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.smoke() if reduced else mod.full()


def resolve_ids(spec) -> list[str]:
    """CLI id resolution: ``"all"`` → every assigned architecture; otherwise
    a comma-separated string (or iterable) of ids/aliases → canonical ids,
    order-preserving and deduped.  Unknown ids raise ``KeyError`` naming the
    known ones."""
    if isinstance(spec, str):
        if spec.strip().lower() == "all":
            return list(ARCH_IDS)
        spec = [s for s in (p.strip() for p in spec.split(",")) if s]
    out: list[str] = []
    for name in spec:
        cid = ALIASES.get(name, name)
        if cid not in ARCH_IDS:
            raise KeyError(f"unknown config id {name!r}; known: "
                           f"{', '.join(ARCH_IDS)} (or 'all')")
        if cid not in out:
            out.append(cid)
    return out
