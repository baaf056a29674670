"""Unified model configuration for all assigned architectures.

One ``ModelConfig`` expresses dense GQA transformers, sliding-window
hybrids (gemma3), MLA+MoE (deepseek-v3), classic MoE (olmoe), SSM
(mamba2), RG-LRU hybrids (recurrentgemma), encoder-decoder backbones
(seamless) and VLM backbones (llava) through a per-layer *block kind*
pattern ``(mixer, ffn)``:

* mixer ∈ ``attn`` (global causal), ``swa`` (sliding window), ``mla``
  (multi-head latent attention), ``ssd`` (Mamba-2 state-space dual),
  ``rglru`` (RecurrentGemma gated linear recurrent unit), ``bidir``
  (encoder self-attention)
* ffn ∈ ``dense`` (SwiGLU), ``moe`` (shared + routed experts), ``none``

The pattern is compressed into scan *segments* (unit × repeats) so the
lowered HLO is O(#distinct segments), not O(#layers).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

Mixer = str
Ffn = str
BlockKind = tuple[Mixer, Ffn]

MIXERS = ("attn", "swa", "mla", "ssd", "rglru", "bidir")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0            # 0 -> n_shared * d_ff_expert
    capacity_factor: float = 1.25
    # dispatch implementation: 'gshard' (einsum one-hot; exact, small scale)
    # or 'scatter' (scatter/gather dispatch; scale, dry-run default)
    dispatch: str = "scatter"
    router_aux_weight: float = 0.001

    @property
    def shared_ff(self) -> int:
        return self.d_ff_shared or self.n_shared * self.d_ff_expert


@dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class RGLRUCfg:
    conv_width: int = 4
    lru_width: int = 0              # 0 -> d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | vlm | audio | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    pattern: tuple[BlockKind, ...] = (("attn", "dense"),)
    window: int = 1024              # sliding-window size for 'swa'
    first_k_dense: int = 0          # deepseek-v3: first k layers use dense ffn
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    rglru: RGLRUCfg | None = None
    # encoder-decoder: n_layers = decoder depth; encoder_layers > 0 adds an
    # encoder stack + cross-attention in every decoder block
    encoder_layers: int = 0
    # input modality: 'tokens' (ids -> embedding) or 'embeds' (precomputed
    # frame/patch embeddings from the stubbed modality frontend)
    input_kind: str = "tokens"
    mtp: bool = False               # deepseek-v3 multi-token prediction head
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    compute_dtype: str = "bfloat16"   # activations dtype ("float32" in tests)
    # pad attention heads to this count inside the attention ops so the
    # head dim divides the TP mesh axis (EXPERIMENTS.md §Perf: 24 or 56
    # heads cannot shard 16 ways; padding trades ≤33% extra attention
    # FLOPs against 16× replication).  0 = no padding.  KV heads are
    # expanded to the padded count as well.
    head_pad: int = 0
    # long-context support marker (sub-quadratic path exists) — drives the
    # long_500k shape-skip logic (DESIGN.md §4)
    subquadratic: bool = False

    # ------------------------------------------------------------------ #
    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def block_kinds(self) -> list[BlockKind]:
        """Per-layer (mixer, ffn) list of length n_layers."""
        kinds: list[BlockKind] = []
        i = 0
        while len(kinds) < self.n_layers:
            kinds.append(self.pattern[i % len(self.pattern)])
            i += 1
        for j in range(min(self.first_k_dense, self.n_layers)):
            kinds[j] = (kinds[j][0], "dense")
        return kinds

    def scan_segments(self) -> list[tuple[tuple[BlockKind, ...], int]]:
        """Compress per-layer kinds into (unit, repeats) scan segments."""
        kinds = self.block_kinds()
        segs: list[tuple[tuple[BlockKind, ...], int]] = []
        unit = tuple(self.pattern)
        i = 0
        while i < len(kinds):
            # try full copies of the configured pattern unit first
            if tuple(kinds[i:i + len(unit)]) == unit:
                r = 0
                while tuple(kinds[i + r * len(unit):i + (r + 1) * len(unit)]) == unit:
                    r += 1
                segs.append((unit, r))
                i += r * len(unit)
                continue
            # fall back to a run of the single current kind
            k = kinds[i]
            r = 1
            while i + r < len(kinds) and kinds[i + r] == k:
                r += 1
            segs.append(((k,), r))
            i += r
        assert sum(len(u) * r for u, r in segs) == self.n_layers
        return segs

    def validate(self) -> None:
        for mixer, ffn in self.pattern:
            if mixer not in MIXERS:
                raise ValueError(f"unknown mixer {mixer!r}")
            if ffn not in FFNS:
                raise ValueError(f"unknown ffn {ffn!r}")
        if any(f == "moe" for _, f in self.block_kinds()) and self.moe is None:
            raise ValueError("moe pattern requires moe config")
        if any(m == "mla" for m, _ in self.block_kinds()) and self.mla is None:
            raise ValueError("mla pattern requires mla config")
        if any(m == "ssd" for m, _ in self.block_kinds()) and self.ssm is None:
            raise ValueError("ssd pattern requires ssm config")
        if any(m == "rglru" for m, _ in self.block_kinds()) and self.rglru is None:
            raise ValueError("rglru pattern requires rglru config")
        if self.input_kind not in ("tokens", "embeds"):
            raise ValueError(f"bad input_kind {self.input_kind!r}")

    def scaled(self, **overrides: Any) -> "ModelConfig":
        """Reduced-config variant for smoke tests."""
        return dataclasses.replace(self, **overrides)
