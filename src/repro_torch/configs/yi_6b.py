"""yi-6b [dense] — llama-arch GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 [arXiv:2403.04652; hf].
"""

from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="decoder",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="swiglu",
    rope_theta=5_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-6b-smoke",
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
)
