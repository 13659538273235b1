"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                 # dense-residual branch hidden size
    vocab=32000,
    n_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    moe_every=1,
    dense_residual=True,       # arctic's dense+MoE parallel design
    rope_theta=1e4,
    sliding_window=8192,
    optimizer="sgdm",
    param_dtype="bfloat16",    # >60B: fp32 master state would exceed v5e HBM
    source="hf:Snowflake/snowflake-arctic-base",
)
