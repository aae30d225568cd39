"""Workload-graph frontend: walk a :class:`~repro_torch.models.common.ModelConfig`
into an operator graph of tensor ops (the paper's "diverse modern foundation
models" input, Fig. 12-style cross-model study).

Each :class:`OpNode` is one operator of the model — a projection GEMM, an
attention score/context GEMM stage, a MoE expert, an SSM depthwise conv, a
patch-embed conv — annotated with its LEGO workload kind
(:mod:`repro_torch.core.workload`: ``gemm`` / ``conv2d`` / ``dwconv2d``), exact
iteration-dim sizes, a repeat count (layers × heads × experts) and the
non-tensor element count that runs on the PPUs (softmax, norms, token-shift,
selective scan).  A :class:`ModelGraph` is the ordered node sequence for one
execution *phase*:

``prefill``
    process ``seq`` tokens per sequence (plus any vision/audio prefix) — the
    throughput-bound regime spatial accelerators target;
``decode``
    one generated token per sequence against a ``seq``-token KV/state
    context — the latency-bound regime (GEMV-shaped workloads).

The graph covers every family in ``repro_torch.configs``: dense/GQA/MQA attention
(``n_kv_heads`` shrinks the KV projection), sliding-window attention,
MoE routed + shared experts, Mamba SSM blocks (in/x/dt/out projections, the
depthwise causal conv as a real ``dwconv`` workload, selective scan on the
PPUs), RWKV-6 time/channel mix with token-shift and the decay LoRA,
encoder-decoder stacks with per-decoder-layer cross-attention, ViT-style
patch-embed stems for vision prefixes and the Whisper audio conv frontend.

Lowering to deduplicated ``(kind, dims, repeat, nontensor)`` rows — the
format consumed by the reference's ``repro.core.fusion.score_fused_design`` and the DSE
evaluator — lives in :mod:`repro_torch.frontend.lower`.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from math import isqrt

from ..models.common import BlockSpec, ModelConfig

__all__ = ["OpNode", "ModelGraph", "build_model_graph", "PHASES"]

PHASES = ("prefill", "decode")

_PATCH = 14     # ViT patch edge for square vision prefixes (CLIP ViT-L/14)
_MEL_BINS = 80  # audio-frontend input channels (Whisper log-mel spectrogram)


@dataclass(frozen=True)
class OpNode:
    """One operator of the model graph.

    ``op`` is the semantic operator name (``qkv_proj``, ``attn_scores``,
    ``expert_up``, ``ssm_conv``, ...); ``kind`` is the LEGO workload it maps
    to (``gemm`` | ``conv`` | ``dwconv`` | ``attn_qk`` | ``attn_pv``, the
    row-kind strings of the reference's ``repro.dse.evaluate``); ``dims`` uses that
    workload's iteration-dim names; ``nontensor`` elements run on the PPUs
    once per node execution.
    """

    name: str
    op: str
    kind: str
    dims: dict[str, int]
    repeat: int = 1
    nontensor: float = 0.0
    stage: str = "decoder"  # frontend | encoder | decoder | head

    @property
    def macs(self) -> int:
        """Total MACs including the repeat count."""
        m = 1
        for v in self.dims.values():
            m *= v
        return m * self.repeat

    def row(self) -> tuple[str, dict[str, int], int, float]:
        """This node as one un-merged lowering row."""
        return (self.kind, dict(self.dims), self.repeat, self.nontensor)


@dataclass(frozen=True)
class ModelGraph:
    """Ordered operator sequence of one model execution phase."""

    model: str
    phase: str
    seq: int
    batch: int
    nodes: tuple[OpNode, ...]

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def macs(self) -> int:
        return sum(n.macs for n in self.nodes)

    def nontensor(self) -> float:
        return sum(n.repeat * n.nontensor for n in self.nodes)

    def ops(self) -> Counter:
        """Node count per semantic operator name."""
        return Counter(n.op for n in self.nodes)

    def lowered(self) -> list[tuple[str, dict[str, int], int, float]]:
        """Deduplicated ``(kind, dims, repeat, nontensor)`` workload rows
        (identical shapes merge by summing repeats; MAC totals preserved)."""
        from .lower import merge_rows
        return merge_rows(n.row() for n in self.nodes)

    def summary(self, limit: int | None = None) -> str:
        """Human-readable node table (used by CLIs and docs/MODELS.md)."""
        hdr = (f"{'node':<28} {'kind':<7} {'rep':>6} {'MMACs':>10}  dims")
        lines = [f"== {self.model} [{self.phase}] seq={self.seq} "
                 f"batch={self.batch}: {self.n_nodes} nodes, "
                 f"{self.macs() / 1e9:.2f} GMACs ==", hdr, "-" * len(hdr)]
        for n in self.nodes[:limit]:
            dims = " ".join(f"{k}={v}" for k, v in n.dims.items())
            lines.append(f"{n.name:<28} {n.kind:<7} {n.repeat:>6} "
                         f"{n.macs / 1e6:>10.1f}  {dims}")
        if limit is not None and self.n_nodes > limit:
            lines.append(f"... ({self.n_nodes - limit} more)")
        return "\n".join(lines)


def build_model_graph(cfg: ModelConfig, *, seq: int = 512, batch: int = 1,
                      phase: str = "prefill",
                      lm_head: bool = True,
                      fused_attention: bool = True) -> ModelGraph:
    """Walk ``cfg`` into a :class:`ModelGraph` for one execution phase.

    ``fused_attention=True`` (default) emits every attention score/context
    stage as a fused ``attn_qk``/``attn_pv`` op pair over the batched
    attention workloads (:func:`repro_torch.core.workload.attention_qk` /
    ``attention_pv``) with the head×batch axis as the batched ``b`` dim —
    the paper's score-stationary fusion where P = softmax(S) stays resident
    between the stages.  ``fused_attention=False`` keeps the historical
    per-GEMM lowering (one GEMM row per head×batch); designs whose dataflow
    set cannot map attention workloads fall back to it through
    :func:`repro_torch.frontend.lower.unfuse_attention_rows` — both forms carry
    identical total MACs and PPU elements.
    """
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    if seq < 1 or batch < 1:
        raise ValueError(f"seq/batch must be >= 1, got seq={seq} batch={batch}")
    has_attn = (cfg.is_encoder_decoder
                or any(s.kind == "attn" for s in cfg.layer_pattern))
    if has_attn and (cfg.n_kv_heads < 1
                     or cfg.n_heads % cfg.n_kv_heads != 0):
        # GQA shares each KV head across an integer group of query heads —
        # a non-divisible count has no defined grouping
        raise ValueError(
            f"GQA requires n_heads divisible by n_kv_heads >= 1, got "
            f"n_heads={cfg.n_heads} n_kv_heads={cfg.n_kv_heads} "
            f"in {cfg.name}")

    d, hd = cfg.d_model, cfg.hd
    prefill = phase == "prefill"
    pre = cfg.prefix_len
    S = seq + pre                      # prefill positions per sequence
    ctx = seq + pre                    # decode attention context length
    toks = (S if prefill else 1) * batch
    nodes: list[OpNode] = []

    def add(stage: str, layer: str, op: str, kind: str, dims: dict,
            rep: int = 1, nt: float = 0.0) -> None:
        nodes.append(OpNode(f"{layer}.{op}", op, kind,
                            {k: int(v) for k, v in dims.items()},
                            int(rep), float(nt), stage))

    # -- input stems (prefill only: prefixes and encoder inputs are cached
    # across decode steps) --------------------------------------------------
    if prefill and pre and not cfg.is_encoder_decoder:
        g = isqrt(pre)
        if g * g == pre:  # ViT-style square patch grid
            dims = dict(n=batch, oc=d, ic=3, oh=g, ow=g, kh=_PATCH, kw=_PATCH)
        else:             # 1-D prefix: framewise conv stem
            dims = dict(n=batch, oc=d, ic=3, oh=pre, ow=1, kh=3, kw=1)
        add("frontend", "stem", "patch_embed", "conv", dims)
    if prefill and cfg.is_encoder_decoder and cfg.enc_seq_len:
        E = cfg.enc_seq_len
        add("frontend", "stem", "audio_embed", "conv",
            dict(n=batch, oc=d, ic=_MEL_BINS, oh=2 * E, ow=1, kh=3, kw=1))
        add("frontend", "stem", "audio_embed_ds", "conv",
            dict(n=batch, oc=d, ic=d, oh=E, ow=1, kh=3, kw=1))

    # -- block emitters ------------------------------------------------------
    def attn_block(stage: str, layer: str, spec: BlockSpec, q_len: int,
                   kv_len: int, n_tok: int, rep: int,
                   causal_prefill: bool = True) -> None:
        eff = min(kv_len, spec.window) if spec.window else kv_len
        add(stage, layer, "qkv_proj", "gemm",
            dict(i=n_tok, j=(cfg.n_heads + 2 * cfg.n_kv_heads) * hd, k=d),
            rep)
        if prefill and causal_prefill:
            si, srep = q_len, cfg.n_heads * batch
        else:  # decode: one query row per sequence, batched on i
            si, srep = batch, cfg.n_heads
        if fused_attention:
            # score-stationary fused pair (paper Fig. 10 "Attention"): the
            # head×batch axis becomes the batched b dim, P = softmax(S) stays
            # resident between the stages (no HBM round trip for scores)
            add(stage, layer, "attn_scores", "attn_qk",
                dict(b=srep, m=si, n=eff, d=hd), rep,
                nt=srep * si * eff)                        # softmax on PPUs
            add(stage, layer, "attn_context", "attn_pv",
                dict(b=srep, m=si, n=eff, d=hd), rep)
        else:
            add(stage, layer, "attn_scores", "gemm", dict(i=si, j=eff, k=hd),
                rep * srep, nt=si * eff)                   # softmax on PPUs
            add(stage, layer, "attn_context", "gemm", dict(i=si, j=hd, k=eff),
                rep * srep)
        add(stage, layer, "out_proj", "gemm",
            dict(i=n_tok, j=d, k=cfg.n_heads * hd), rep,
            nt=n_tok * d)                                  # residual + norm

    def ffn_block(stage: str, layer: str, spec: BlockSpec, n_tok: int,
                  rep: int) -> None:
        n_up = 2 if cfg.glu else 1
        if spec.moe and cfg.n_experts:
            ff = cfg.d_ff_e
            active = cfg.top_k + cfg.n_shared_experts
            add(stage, layer, "router", "gemm",
                dict(i=n_tok, j=cfg.n_experts, k=d), rep,
                nt=n_tok * cfg.n_experts)                  # top-k on PPUs
            add(stage, layer, "expert_up", "gemm", dict(i=n_tok, j=ff, k=d),
                rep * n_up * active)
            add(stage, layer, "expert_down", "gemm", dict(i=n_tok, j=d, k=ff),
                rep * active, nt=n_tok * d)
        else:
            add(stage, layer, "ffn_up", "gemm",
                dict(i=n_tok, j=cfg.d_ff, k=d), rep * n_up)
            add(stage, layer, "ffn_down", "gemm",
                dict(i=n_tok, j=d, k=cfg.d_ff), rep, nt=n_tok * d)

    def mamba_block(stage: str, layer: str, n_tok: int, steps: int,
                    rep: int) -> None:
        di, dtr, ds = cfg.d_inner, cfg.dtr, cfg.d_state
        add(stage, layer, "ssm_in_proj", "gemm", dict(i=n_tok, j=2 * di, k=d),
            rep)
        add(stage, layer, "ssm_conv", "dwconv",   # depthwise causal conv1d
            dict(n=batch, c=di, oh=steps, ow=1, kh=cfg.d_conv, kw=1), rep)
        add(stage, layer, "ssm_x_proj", "gemm",
            dict(i=n_tok, j=dtr + 2 * ds, k=di), rep)
        add(stage, layer, "ssm_dt_proj", "gemm", dict(i=n_tok, j=di, k=dtr),
            rep)
        add(stage, layer, "ssm_out_proj", "gemm", dict(i=n_tok, j=d, k=di),
            rep, nt=n_tok * di * (ds + 1))        # selective scan + gating

    def rwkv_block(stage: str, layer: str, n_tok: int, rep: int) -> None:
        dr = cfg.rwkv_decay_rank
        add(stage, layer, "rwkv_time_mix", "gemm", dict(i=n_tok, j=d, k=d),
            rep * 4, nt=n_tok * d)                # r/k/v/g + token-shift lerp
        add(stage, layer, "rwkv_decay_lora", "gemm", dict(i=n_tok, j=dr, k=d),
            rep)
        add(stage, layer, "rwkv_decay_proj", "gemm", dict(i=n_tok, j=d, k=dr),
            rep)
        add(stage, layer, "rwkv_out_proj", "gemm", dict(i=n_tok, j=d, k=d),
            rep, nt=2 * n_tok * d)                # wkv scan + group norm
        add(stage, layer, "rwkv_channel_up", "gemm",
            dict(i=n_tok, j=cfg.d_ff, k=d), rep, nt=n_tok * d)  # token-shift
        add(stage, layer, "rwkv_channel_down", "gemm",
            dict(i=n_tok, j=d, k=cfg.d_ff), rep)

    # -- decoder stack: the layer pattern × n_periods ------------------------
    for i, spec in enumerate(cfg.layer_pattern):
        layer, rep = f"dec{i}", cfg.n_periods
        if spec.kind == "attn":
            attn_block("decoder", layer, spec, S, ctx, toks, rep)
        elif spec.kind == "mamba":
            mamba_block("decoder", layer, toks, S if prefill else 1, rep)
        elif spec.kind == "rwkv":
            rwkv_block("decoder", layer, toks, rep)
        else:
            raise ValueError(f"unknown block kind {spec.kind!r} "
                             f"in {cfg.name}")
        if spec.kind in ("attn", "mamba"):  # rwkv carries its channel mix
            ffn_block("decoder", layer, spec, toks, rep)

    # -- encoder stack + per-decoder-layer cross-attention -------------------
    if cfg.is_encoder_decoder and cfg.n_enc_layers and cfg.enc_seq_len:
        E, enc_toks = cfg.enc_seq_len, cfg.enc_seq_len * batch
        enc_spec = cfg.layer_pattern[0]
        if prefill:  # the encoder runs once; decode reuses its states
            attn_block("encoder", "enc", enc_spec, E, E, enc_toks,
                       cfg.n_enc_layers)
            ffn_block("encoder", "enc", enc_spec, enc_toks, cfg.n_enc_layers)
        n_dec = cfg.n_layers
        add("decoder", "xattn", "cross_q_proj", "gemm",
            dict(i=toks, j=cfg.n_heads * hd, k=d), n_dec)
        if prefill:  # cross K/V computed once per layer, cached for decode
            add("decoder", "xattn", "cross_kv_proj", "gemm",
                dict(i=enc_toks, j=2 * cfg.n_kv_heads * hd, k=d), n_dec)
        si, srep = (S, cfg.n_heads * batch) if prefill else (batch,
                                                            cfg.n_heads)
        if fused_attention:
            add("decoder", "xattn", "cross_scores", "attn_qk",
                dict(b=srep, m=si, n=E, d=hd), n_dec, nt=srep * si * E)
            add("decoder", "xattn", "cross_context", "attn_pv",
                dict(b=srep, m=si, n=E, d=hd), n_dec)
        else:
            add("decoder", "xattn", "cross_scores", "gemm",
                dict(i=si, j=E, k=hd), n_dec * srep, nt=si * E)
            add("decoder", "xattn", "cross_context", "gemm",
                dict(i=si, j=hd, k=E), n_dec * srep)
        add("decoder", "xattn", "cross_out_proj", "gemm",
            dict(i=toks, j=d, k=cfg.n_heads * hd), n_dec, nt=toks * d)

    # -- LM head over the text positions -------------------------------------
    if lm_head:
        out_toks = (seq if prefill else 1) * batch
        add("head", "head", "lm_head", "gemm",
            dict(i=out_toks, j=cfg.vocab_size, k=d))

    return ModelGraph(model=cfg.name, phase=phase, seq=seq, batch=batch,
                      nodes=tuple(nodes))
