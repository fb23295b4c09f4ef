"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf].  Period-8 pattern: 1 attention + 7 Mamba layers; MoE MLP
every second layer (the Jamba recipe).  ~398B total / ~94B active parameters.
Hybrid SSM majority => runs the long_500k decode cell (state is O(1) in seq).
"""

from repro_torch.configs.base import BlockCfg, ModelConfig, MoECfg


def _blk(mixer: str, idx: int) -> BlockCfg:
    return BlockCfg(mixer=mixer, mlp="moe" if idx % 2 == 1 else "dense")


_PATTERN = tuple(_blk("attn" if j == 0 else "mamba", j) for j in range(8))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="decoder",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    mlp_act="swiglu",
    moe=MoECfg(num_experts=16, top_k=2, d_expert=24576),
    ssm_state_dim=16,
    ssm_expand=2,
    rope_type="none",          # jamba uses no positional encoding in attn layers
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke",
    family="decoder",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),
             BlockCfg(mixer="mamba", mlp="moe"),
             BlockCfg(mixer="mamba", mlp="dense"),
             BlockCfg(mixer="mamba", mlp="moe")),
    mlp_act="swiglu",
    moe=MoECfg(num_experts=4, top_k=2, d_expert=96),
    ssm_state_dim=4,
    ssm_expand=2,
    rope_type="none",
)
