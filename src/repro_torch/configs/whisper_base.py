"""whisper-base [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

``n_layers`` is the decoder depth; ``encoder_layers`` the encoder depth.
The mel-spectrogram + conv feature extractor is a STUB per the assignment
carve-out: ``input_specs()`` supplies precomputed frame embeddings
(B, encoder_seq, d_model)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    encoder_layers=6,
    encoder_seq=1500,          # 30 s of audio at 50 frames/s
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    qkv_bias=True,
    tie_embeddings=True,       # whisper ties decoder embed/unembed (74M total)
    sliding_window=8192,       # decoder self-attn window for long_500k
    source="arXiv:2212.04356",
)
