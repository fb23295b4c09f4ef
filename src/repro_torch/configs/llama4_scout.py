"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Early fusion is a frontend
concern and is left out (the text path).  Its 107,769,364,480 weights fit on
no single card: at full width it waits for the distributed part of ROADMAP
slice 10.
"""

from repro_torch.configs.base import BlockCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="decoder",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(BlockCfg(mixer="attn", mlp="moe"),),
    mlp_act="swiglu",
    moe=MoECfg(num_experts=16, top_k=1, d_expert=8192, num_shared=1),
    rope_theta=500_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="llama4-scout-smoke",
    family="decoder",
    num_layers=2,
    d_model=64,
    num_heads=5,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="moe"),),
    mlp_act="swiglu",
    moe=MoECfg(num_experts=4, top_k=1, d_expert=96, num_shared=1),
)
