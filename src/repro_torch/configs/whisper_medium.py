"""whisper-medium [audio] — enc-dec, conv frontend stubbed per assignment.

24L (24 enc + 24 dec) d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified].  The audio conv frontend is a STUB: the model
takes precomputed frame embeddings ``enc_embeds`` (B, 1500, d_model), which
``registry.concrete_batch`` makes from a seed.
"""

from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="geglu",
    encoder_layers=24,
    encoder_seq=1500,
    frontend="audio",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-medium-smoke",
    family="encdec",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=(BlockCfg(mixer="attn", mlp="dense"),),
    mlp_act="geglu",
    encoder_layers=2,
    encoder_seq=12,
    frontend="audio",
)
