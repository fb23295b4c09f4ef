"""qwen2-vl-72b [vlm] — M-RoPE, dynamic-resolution vision frontend stubbed.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191; hf].
The vision frontend is a STUB: the model takes precomputed patch embeddings
``embeds`` (B, S, d_model) and the (B, 3, S) M-RoPE position streams
``positions``, which ``registry.concrete_batch`` makes from a seed.
"""

from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="decoder",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="swiglu",
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-72b-smoke",
    family="decoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="swiglu",
    rope_type="mrope",
    mrope_sections=(2, 3, 3),
    frontend="vision",
)
