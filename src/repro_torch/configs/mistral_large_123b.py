"""mistral-large-123b [dense] — [hf:mistralai/Mistral-Large-Instruct-2407]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    rope_theta=1e6,
    sliding_window=8192,       # long_500k decode variant (DESIGN.md §4)
    optimizer="sgdm",
    param_dtype="bfloat16",    # >60B: fp32 master state would exceed v5e HBM          # >50B: halve optimizer-state HBM vs adamw
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
