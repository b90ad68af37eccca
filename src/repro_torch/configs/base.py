"""Configuration system: model configs (assigned architecture pool) + shapes
(port of ``repro.configs.base``, which imports no JAX; kept as a copy).

Every assigned architecture is a ``ModelConfig``; input-shape cells are
``ShapeConfig``s. ``reduced()`` produces the CPU-smoke-test variant of the
same family (small layers/width/experts, tiny vocab) per the assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0  # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    router_aux_free: bool = False  # DeepSeek aux-loss-free bias routing

    # -- MLA (DeepSeek) -------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0  # multi-token-prediction modules

    # -- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0  # 0 -> d_inner // 64
    hybrid_attn_every: int = 0  # zamba: shared attn block applied every k layers
    slstm_layers: tuple[int, ...] = ()  # xlstm: which layers are sLSTM
    attn_window: int = 0  # sliding window cap for hybrid long-context attn

    # -- encoder-decoder / frontend stubs ------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 0  # stub frame count (whisper: 1500)
    n_patches: int = 0  # vlm stub patch count injected at sequence head
    max_decode_len: int = 0  # architectural decoder context (0 = unlimited)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_recurrent(self) -> bool:
        """True if decode state is O(1) in sequence length (SSM families)."""
        return self.family in ("hybrid", "ssm")

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: sub-quadratic / O(1)-state decode families."""
        return self.is_recurrent

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        total += self._block_params()
        return total

    def _block_params(self) -> int:
        d = self.d_model
        hd = self.head_dim
        # attention
        if self.use_mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn_dense = 3 * d * self.d_ff
        if self.is_moe:
            expert = 3 * d * self.d_ff_expert
            moe = self.n_experts * expert + self.n_shared_experts * expert + d * self.n_experts
            n_moe = self.n_layers - self.n_dense_layers
            ffn_total = self.n_dense_layers * ffn_dense + n_moe * moe
            return self.n_layers * attn + ffn_total
        if self.family in ("hybrid", "ssm"):
            d_in = self.ssm_expand * d
            ssm = d * (2 * d_in + 2 * self.ssm_state) + d_in * d  # rough
            return self.n_layers * ssm + (attn + ffn_dense) * max(
                1, self.n_layers // max(self.hybrid_attn_every, 1) if self.hybrid_attn_every else self.n_layers
            )
        enc = self.n_encoder_layers * (attn + 2 * d * self.d_ff)
        dec_cross = self.n_layers * attn if self.is_encoder_decoder else 0
        return self.n_layers * (attn + ffn_dense) + enc + dec_cross

    def active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        expert = 3 * d * self.d_ff_expert
        n_moe = self.n_layers - self.n_dense_layers
        dense_total = self.n_params() - n_moe * (self.n_experts - 0) * expert
        active_moe = n_moe * (self.experts_per_token + self.n_shared_experts) * expert
        return dense_total + active_moe

    def reduced(self) -> "ModelConfig":
        """Smoke-test config of the same family: tiny dims, same structure."""
        scale = dict(
            n_layers=min(self.n_layers, 4 if not self.hybrid_attn_every else 5),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_head=32,
            d_ff=256,
            vocab_size=512,
            dtype="float32",
        )
        if self.is_moe:
            scale.update(
                n_experts=8,
                experts_per_token=min(self.experts_per_token, 2),
                d_ff_expert=64,
                n_dense_layers=min(self.n_dense_layers, 1),
            )
        if self.use_mla:
            scale.update(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32, d_head=0,
            )
        if self.family in ("hybrid", "ssm"):
            scale.update(ssm_state=16, ssm_heads=4, d_head=32)
        if self.slstm_layers:
            scale.update(n_layers=4, slstm_layers=(1, 3))
        if self.hybrid_attn_every:
            scale.update(hybrid_attn_every=2)
        if self.is_encoder_decoder:
            scale.update(n_encoder_layers=2, encoder_len=64)
        if self.n_patches:
            scale.update(n_patches=16)
        if self.mtp_depth:
            scale.update(mtp_depth=1)
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The assigned LM shape set (seq_len x global_batch); decode_* / long_* lower
# serve_step (one new token against a KV cache of seq_len), not train_step.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not) per the assignment's skip rules."""
    if shape.name == "long_500k" and not model.supports_long_context:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
