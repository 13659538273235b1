"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 on alternate layers [arXiv:2403.19887].

Layer pattern (8-layer super-block, scanned 9x): layers 0-6 mamba, layer 7
attention; MoE FFN on odd layers, dense FFN on even layers."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,              # 1 attention per 8 layers (1:7)
    scan_block=8,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_groups=8,
    rope_theta=1e6,
    optimizer="sgdm",
    param_dtype="bfloat16",    # >60B: fp32 master state would exceed v5e HBM
    source="arXiv:2403.19887",
)
