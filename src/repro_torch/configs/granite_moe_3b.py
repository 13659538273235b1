"""granite-moe-3b-a800m [moe] — MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

Note: the assignment line specifies "MoE 40e top-8" while its bracket
comment says "32 experts"; we follow the spec line (40 experts), which also
matches the 3B-total / 800M-active budget with d_ff=512 experts."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                  # expert hidden size
    vocab=49155,
    n_experts=40,
    experts_per_token=8,
    moe_every=1,
    rope_theta=1e4,
    sliding_window=8192,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
