"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3-1b-pt; unverified].  Pattern period 6 (5 local @1024 window +
1 global); 34 = 5·6 + 4 leaves a 4-layer tail.  The sliding-window majority is
why this arch runs the long_500k decode cell (ring-buffer caches cap at the
window size; only the 6 global layers hold full-length KV).
"""

from repro_torch.configs.base import BlockCfg, ModelConfig

_LOCAL = BlockCfg(mixer="attn", mlp="dense", window=1024)
_GLOBAL = BlockCfg(mixer="attn", mlp="dense", window=0)

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="decoder",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    mlp_act="geglu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-4b-smoke",
    family="decoder",
    num_layers=8,   # 1 full period (6) + 2-layer tail: exercises both paths
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="dense", window=8),) * 5
            + (BlockCfg(mixer="attn", mlp="dense", window=0),),
    mlp_act="geglu",
    tie_embeddings=True,
)
