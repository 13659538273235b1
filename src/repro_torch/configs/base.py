"""Architecture/model configuration system.

``ModelConfig`` fully describes every assigned architecture (DESIGN.md §4)
plus the paper's own FL models.  Configs are declarative; the model builders
in ``repro_torch.models`` and the step builders in
``repro_torch.launch`` consume them (a copy of ``repro.configs``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 => attention-free
    n_kv_heads: int
    d_ff: int                      # dense-FFN hidden size (0 => no dense FFN)
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    mlp_type: str = "swiglu"       # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # expert hidden size (0 => d_ff)
    moe_every: int = 1             # MoE on layers with (i % moe_every == moe_every-1)
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    expert_shard_axis: str = ""    # set by launch.steps: wsc experts to this
                                   # mesh axis through fwd+bwd (SS Perf)
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0            # hybrid: attention on layers (i % attn_every == attn_every-1)
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 0           # stub-frontend output frames (whisper: 1500)
    # --- vlm ---
    n_patches: int = 0             # stub-frontend patch embeddings per image
    # --- misc ---
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    causal_skip: bool = False      # triangular block schedule (§Perf opt)
    embed_mode: str = "gather"     # gather | onehot (§Perf: onehot makes the
                                   # embedding gradient a shardable dot)
    tie_embeddings: bool = False
    sliding_window: int = 0        # decode long-context variant (0 => full)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_block: int = 1            # layers per scan step (hybrid super-block)
    remat: bool = True
    optimizer: str = "adamw"
    source: str = ""               # provenance citation

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.n_layers % self.scan_block:
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of scan_block {self.scan_block}")
        # the layer pattern must repeat with the scan-block period so that
        # stacked blocks are homogeneous (see models.transformer)
        for period in (self.attn_every, self.moe_every):
            if period > 1 and self.scan_block % period:
                raise ValueError(f"{self.name}: scan_block {self.scan_block} "
                                 f"must be a multiple of pattern period {period}")

    # --- layer-pattern helpers -----------------------------------------
    def layer_kind(self, i: int) -> str:
        """"attn" or "mamba" mixer for decoder layer ``i``."""
        if self.family in ("ssm",):
            return "mamba"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every == self.attn_every - 1) else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every == self.moe_every - 1)

    @property
    def n_scan_blocks(self) -> int:
        return self.n_layers // self.scan_block

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode available (SSM/hybrid native; dense via
        sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    # --- analytic parameter count (validates configs vs published sizes) ---
    def _attn_params(self) -> int:
        qkv = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        if self.qkv_bias:
            qkv += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        out = self.n_heads * self.head_dim * self.d_model
        return qkv + out

    def _dense_ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.mlp_type == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _moe_ffn_params(self) -> int:
        router = self.d_model * self.n_experts
        mult = 3 if self.mlp_type == "swiglu" else 2
        return router + self.n_experts * mult * self.d_model * self.moe_d_ff

    def _mamba_params(self) -> int:
        d_in, n, g, h = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
        in_proj = self.d_model * (2 * d_in + 2 * g * n + h)
        conv = self.ssm_conv * (d_in + 2 * g * n)
        out_proj = d_in * self.d_model
        extras = 3 * h + d_in            # A, D, dt_bias, gated norm
        return in_proj + conv + out_proj + extras

    def param_count(self) -> int:
        """Analytic decoder(+encoder) parameter count, norms excluded
        (they are < 0.01% for all assigned configs)."""
        total = self.vocab * self.d_model          # embedding
        if not self.tie_embeddings:
            total += self.vocab * self.d_model     # unembedding
        for i in range(self.n_layers):
            if self.layer_kind(i) == "attn":
                total += self._attn_params()
            else:
                total += self._mamba_params()
            if self.layer_is_moe(i):
                total += self._moe_ffn_params()
                if self.dense_residual:
                    total += self._dense_ffn_params(self.d_ff)
            elif self.d_ff:
                total += self._dense_ffn_params(self.d_ff)
        if self.is_encdec:  # encoder self-attn + ffn, cross-attn in decoder
            total += self.encoder_layers * (self._attn_params()
                                            + self._dense_ffn_params(self.d_ff))
            total += self.n_layers * self._attn_params()   # cross-attention
            total += self.encoder_seq * self.d_model       # enc positional emb
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses experts_per_token of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        for i in range(self.n_layers):
            if self.layer_is_moe(i):
                mult = 3 if self.mlp_type == "swiglu" else 2
                inactive = ((self.n_experts - self.experts_per_token)
                            * mult * self.d_model * self.moe_d_ff)
                total -= inactive
        return total


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """The smoke-test variant: same family/pattern, tiny dimensions.

    2 scan-blocks of layers, d_model <= 512, <= 4 experts — per the assignment
    rules.  Ratios (GQA grouping, MoE top-k, attn:mamba interleave) are kept.
    """
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)) if cfg.n_heads else 1
    d_model = min(cfg.d_model, 256)
    n_heads = 4 if cfg.n_heads else 0
    small = dict(
        n_layers=2 * cfg.scan_block,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=max(1, n_heads // kv_ratio) if n_heads else 0,
        head_dim=d_model // n_heads if n_heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.n_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=64,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=min(cfg.encoder_seq, 32) if cfg.encoder_seq else 0,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
