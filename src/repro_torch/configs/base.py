"""Config schema for the assigned architectures.

A single ``ModelConfig`` drives the composable model in
``repro_torch.models.model`` — every assigned architecture is a value of this
dataclass (one file per arch in this package).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0              # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    router_chunk: int = 512        # dispatch is scanned over seq chunks of
                                   # this size to bound dispatch-mask memory
    dense_residual_ff: int = 0     # arctic-style dense FFN in parallel


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None            # default d_model // n_heads
    activation: str = "silu"               # silu | geglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float | None = None

    # attention pattern: layers with (index % local_global_period) ==
    # local_global_period-1 are global; others use the sliding window.
    sliding_window: int | None = None
    local_global_period: int | None = None  # gemma3: 6 (5 local : 1 global)

    # encoder-decoder (seamless): sizes of the two stacks; n_layers is the
    # decoder depth when encoder_layers > 0.
    encoder_layers: int = 0

    # MoE
    moe: MoEConfig | None = None

    # hybrid / ssm
    block_pattern: tuple[str, ...] | None = None  # e.g. ("mlstm", "slstm")
    ssm_state: int = 0
    ssm_head_dim: int = 64
    shared_attn_period: int = 0   # zamba2: one *shared-weight* attn block
                                  # after every N ssm layers

    # modality frontend stub (assignment: frontends are stubs that accept
    # precomputed frame/patch embeddings)
    frontend: Literal[None, "audio", "vision"] = None

    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attends(self) -> bool:
        """True if any layer is an attention layer."""
        if self.block_pattern is None:
            return True
        return "attn" in self.block_pattern or self.shared_attn_period > 0

    @property
    def pure_full_attention(self) -> bool:
        """True for archs where every token layer is full (non-windowed)
        attention — these skip the long_500k cell (DESIGN.md)."""
        return (
            self.block_pattern is None
            and self.sliding_window is None
            and self.ssm_state == 0
        )

    def layer_kind(self, i: int) -> str:
        """Static block kind for layer i: attn | attn_global | attn_local |
        mamba2 | slstm | mlstm."""
        if self.block_pattern is not None:
            return self.block_pattern[i % len(self.block_pattern)]
        if self.local_global_period:
            if i % self.local_global_period == self.local_global_period - 1:
                return "attn_global"
            return "attn_local"
        return "attn"

    # ------------------------------------------------------------------
    # parameter / flop accounting (roofline §7)
    # ------------------------------------------------------------------

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        qo = self.n_heads * hd * d * 2
        kv = self.n_kv_heads * hd * d * 2
        attn = qo + kv
        glu = self.activation in ("geglu", "silu")
        mlp = d * f * (3 if glu else 2)
        per_layer = 0
        n_attn = n_ffn = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind.startswith("attn"):
                per_layer += attn + (mlp if f else 0)
            elif kind == "mamba2":
                d_in = 2 * d
                per_layer += d * (2 * d_in + 2 * self.ssm_state
                                  + d_in // self.ssm_head_dim) + d_in * d
            elif kind in ("slstm", "mlstm"):
                d_in = 2 * d
                per_layer += d * d_in * 4 + d_in * d  # qkv/gates + out
        if self.shared_attn_period:
            per_layer += 0  # counted once below
        total = per_layer
        if self.shared_attn_period:
            total += attn + mlp  # single shared block
        if self.moe is not None:
            m = self.moe
            expert = d * m.d_expert * 3
            per_moe = (m.n_experts * expert + m.n_shared * expert
                       + d * m.n_experts)
            if m.dense_residual_ff:
                per_moe += d * m.dense_residual_ff * 3
            total += self.n_layers * per_moe
            # attention params were counted with f=d_ff; for MoE archs d_ff
            # is the expert size, so drop the double-counted dense mlp
            total -= self.n_layers * mlp
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + mlp)
            dec_cross = self.n_layers * attn   # cross-attention blocks
            total += enc + dec_cross
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        expert = d * m.d_expert * 3
        inactive = (m.n_experts - m.top_k) * expert * self.n_layers
        return self.param_count() - inactive
