"""xlstm-350m [ssm] — alternating mLSTM + sLSTM blocks, attention-free.

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
d_ff = 0: the xLSTM blocks carry their own up/down projections (expand factor 2),
so the MLP slot is "none".  Attention-free => runs the long_500k decode cell.
"""

from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="decoder",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    pattern=(BlockCfg(mixer="mlstm", mlp="none"),
             BlockCfg(mixer="slstm", mlp="none")),
    rope_type="none",
    ssm_expand=2,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-smoke",
    family="decoder",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=256,
    pattern=(BlockCfg(mixer="mlstm", mlp="none"),
             BlockCfg(mixer="slstm", mlp="none")),
    rope_type="none",
    ssm_expand=2,
    tie_embeddings=True,
)
