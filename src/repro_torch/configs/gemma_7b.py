"""gemma-7b [dense] — GeGLU, head_dim=256, tied embeddings.

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000 [arXiv:2403.08295; hf].
"""

from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="decoder",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="geglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma-7b-smoke",
    family="decoder",
    num_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    head_dim=32,
    d_ff=192,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="geglu",
    tie_embeddings=True,
)
