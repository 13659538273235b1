"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    rope_theta=1e4,
    sliding_window=8192,
    optimizer="sgdm",
    param_dtype="bfloat16",    # >60B: fp32 master state would exceed v5e HBM
    source="arXiv:2401.02954",
)
