"""internvl2-1b [vlm] — InternViT (stub) + InternLM2/Qwen2-arch decoder
[arXiv:2404.16821].

The vision encoder + projector are a STUB per the assignment carve-out:
``input_specs()`` supplies projected patch embeddings (B, n_patches, d_model)
which the decoder consumes ahead of the text tokens."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,
    n_patches=256,             # stub ViT output tokens per image
    rope_theta=1e6,
    sliding_window=8192,
    source="arXiv:2404.16821",
)
