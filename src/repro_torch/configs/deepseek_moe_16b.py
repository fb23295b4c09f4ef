"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert width) vocab=102400
[arXiv:2401.06066; hf].  16,879,452,160 weights by ``param_count``; the
published checkpoint stores them in bfloat16.
"""

from repro_torch.configs.base import BlockCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="decoder",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    pattern=(BlockCfg(mixer="attn", mlp="moe"),),
    mlp_act="swiglu",
    moe=MoECfg(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-moe-smoke",
    family="decoder",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=48,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="moe"),),
    mlp_act="swiglu",
    moe=MoECfg(num_experts=8, top_k=3, d_expert=48, num_shared=2),
)
