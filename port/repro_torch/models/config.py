"""Model configuration covering every assigned architecture family.

The port's own copy of ``repro.models.config.ModelConfig`` (data only;
the port imports nothing of ``repro``), field for field the same.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None

    # attention variants
    qkv_bias: bool = False
    logit_softcap: float | None = None    # gemma2 final-logit softcap
    attn_softcap: float | None = None     # gemma2 attention softcap
    window: int | None = None             # SWA (mixtral)
    local_global: bool = False            # gemma2 alternating local/global
    local_window: int = 4096
    post_norms: bool = False              # gemma2 sandwich norms
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False          # arctic dense+MoE parallel
    moe_ff: int | None = None             # expert hidden size if != d_ff
    shard_experts: bool = True            # EP over the model axis

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2

    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "local")
    rglru_width: int | None = None

    # encoder-decoder (whisper)
    enc_layers: int = 0
    src_len: int = 1500

    # vlm (internvl): stub frontend provides patch embeddings
    vis_tokens: int = 0
    vis_dim: int = 0

    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a 256 multiple so the unembed shards over the
        model axis (and rows align with the MXU); padded logit rows are
        masked to -1e9 in loss/decode."""
        return -(-self.vocab // 256) * 256

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        if self.family == "ssm":
            return ("ssm",)
        if self.local_global:
            return ("local", "global")
        if self.family == "moe":
            return ("moe",)
        return ("full",)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND model-flops)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, h, kv = self.hd, self.n_heads, self.n_kv
        total = v * d * (1 if self.tie_embeddings else 2)
        per = {}
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = 3 * d * f
        fe = self.moe_ff or f
        moe = self.n_experts * 3 * d * fe + d * self.n_experts
        din = self.ssm_expand * d
        ssm = d * (2 * din + 2 * self.ssm_groups * self.ssm_state
                   + self.ssm_heads) + din * d
        w = self.rglru_width or d
        rec = 2 * d * w + w * d + 3 * w
        per["full"] = per["local"] = per["global"] = attn + mlp
        per["moe"] = attn + moe + (mlp if self.dense_residual else 0)
        per["ssm"] = ssm
        per["rec"] = rec + mlp
        pat = self.pattern
        for i in range(self.n_layers):
            kind = pat[i % len(pat)]
            total += per.get(kind, attn + mlp)
        if self.family == "encdec":
            total += self.enc_layers * (2 * attn + mlp)  # self+cross approx
        if self.family == "vlm":
            total += self.vis_dim * self.d_model
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        fe = self.moe_ff or self.d_ff
        full = self.n_params()
        inactive = (self.n_experts - self.top_k) * 3 * d * fe
        pat = self.pattern
        n_moe = sum(1 for i in range(self.n_layers)
                    if pat[i % len(pat)] == "moe")
        return full - n_moe * inactive
