"""mamba2-370m [ssm] — attention-free SSD [arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=0,                    # mamba blocks only, no separate FFN
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
