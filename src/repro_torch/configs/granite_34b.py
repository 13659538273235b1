"""granite-34b [dense] — llama/GPTBigCode-arch code model, MQA (kv=1),
non-gated GeLU MLP [arXiv:2405.04324]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,              # multi-query attention
    d_ff=24576,
    vocab=49152,
    mlp_type="gelu",           # 2-matrix FFN (matches 34B total params)
    norm_type="layernorm",
    rope_theta=1e4,
    sliding_window=8192,
    source="arXiv:2405.04324",
)
