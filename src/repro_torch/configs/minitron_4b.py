"""minitron-4b [dense] — pruned nemotron (squared-ReLU MLP).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000 [arXiv:2407.14679; hf].
"""

from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="decoder",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="relu2",
)

SMOKE_CONFIG = ModelConfig(
    name="minitron-4b-smoke",
    family="decoder",
    num_layers=2,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="relu2",
)
