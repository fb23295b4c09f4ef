"""The decoder stack (``repro.models.transformer``): full-sequence forward and
single-token decode with ring-buffer KV caches.

``Model`` is an ``nn.Module`` holding one parameter tree per layer; layers run
as a Python loop over them (the reference stacks the layers of each pattern
period and scans over the stack).  The port builds decoders whose layers are
attention mixers with dense MLPs; MoE, SSM/xLSTM mixers and encoder-decoder
models are ROADMAP slice 8 and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.core.policy import Policy
from repro_torch.models import attention, layers


def _check_block(cfg: ModelConfig, blk: BlockCfg) -> None:
    if cfg.family != "decoder" or blk.mixer != "attn" or blk.mlp != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with mixer {blk.mixer!r} and mlp {blk.mlp!r} "
            f"is not ported yet (ROADMAP slice 8: MoE, SSM/xLSTM and encoder-decoder "
            f"models); the port builds decoders of attention mixers and dense MLPs")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, blk: BlockCfg) -> Dict:
    _check_block(cfg, blk)
    dt = cfg.param_torch_dtype
    return {"norm1": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
            "mixer": attention.attn_init(gen, cfg),
            "norm2": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, act=cfg.mlp_act)}


def block_apply(p: Dict, x: torch.Tensor, blk: BlockCfg, cfg: ModelConfig, policy: Policy,
                sin, cos, causal: bool = True) -> torch.Tensor:
    h = layers.rmsnorm_apply(p["norm1"], x)
    x = x + attention.attn_apply(p["mixer"], h, cfg, policy, sin, cos, window=blk.window,
                                 causal=causal)
    h2 = layers.rmsnorm_apply(p["norm2"], x)
    return x + layers.mlp_apply(p["mlp"], h2, policy, cfg.mlp_act)


def block_cache_init(cfg: ModelConfig, blk: BlockCfg, batch: int, seq_len: int,
                     device) -> Dict:
    return {"kv": attention.cache_init(cfg, batch, seq_len, blk.window, device=device)}


def block_decode_step(p: Dict, x: torch.Tensor, cache: Dict, blk: BlockCfg, cfg: ModelConfig,
                      policy: Policy, pos: int, sin, cos) -> Tuple[torch.Tensor, Dict]:
    h = layers.rmsnorm_apply(p["norm1"], x)
    mo, kv = attention.attn_decode_step(p["mixer"], h, cache["kv"], pos, cfg, policy, sin, cos,
                                        window=blk.window)
    x = x + mo
    h2 = layers.rmsnorm_apply(p["norm2"], x)
    return x + layers.mlp_apply(p["mlp"], h2, policy, cfg.mlp_act), {"kv": kv}


# ---------------------------------------------------------------------------
# Parameter trees as modules
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors registered as (frozen) parameters, so that the
    model's ``state_dict`` names them by path (``layers.0.mixer.wq.w``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def _unflatten(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, val in state.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """A decoder over ``cfg``: ``embed``, ``layers.{i}``, ``final_norm`` and
    ``lm_head`` (absent with tied embeddings).  Build its weights with
    ``init(generator)`` or carry them in with ``load(state)``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            _check_block(cfg, cfg.block_at(i))

    @property
    def policy(self) -> Policy:
        return Policy(self.cfg.policy_name)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # --- weights --------------------------------------------------------------

    def init(self, gen: torch.Generator) -> "Model":
        """Random weights from ``gen``, made on its device."""
        cfg = self.cfg
        dt = cfg.param_torch_dtype
        tree: Dict[str, Any] = {
            "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "final_norm": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
            "layers": {str(i): block_init(gen, cfg, cfg.block_at(i))
                       for i in range(cfg.num_layers)},
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
        return self._set(tree)

    def load(self, state: Dict[str, torch.Tensor]) -> "Model":
        """Weights from a flat state dict (``convert.params_from_jax`` makes one)."""
        return self._set(_unflatten(state))

    def _set(self, tree: Dict[str, Any]) -> "Model":
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.layers = nn.ModuleList(ParamTree(tree["layers"][str(i)])
                                    for i in range(self.cfg.num_layers))
        if not self.cfg.tie_embeddings:
            self.lm_head = ParamTree(tree["lm_head"])
        return self

    # --- shared pieces --------------------------------------------------------

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        if cfg.rope_type == "none":
            z = torch.zeros((positions.shape[-1], cfg.head_dim // 2), device=positions.device)
            return z, 1.0 + z
        if cfg.rope_type != "standard":
            raise NotImplementedError(f"rope {cfg.rope_type!r} is ROADMAP slice 8")
        return layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.rmsnorm_apply(self.final_norm.tree(), x)
        if cfg.tie_embeddings:
            logits = layers.unembed_apply(self.embed.tree(), x, self.policy)
        else:
            logits = layers.dense_apply(self.lm_head.tree(), x, self.policy).float()
        return layers.softcap(logits, cfg.logit_softcap)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.embed_apply(self.embed.tree(), tokens, cfg.compute_torch_dtype)
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)

    # --- forward (prefill) ------------------------------------------------------

    @torch.no_grad()
    def apply(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {"tokens" (B, S) int | "embeds" (B, S, d)}; returns
        (logits float32 (B, S, V), aux loss 0)."""
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(cfg.compute_torch_dtype)
        else:
            x = self._embed(batch["tokens"])
        S = x.shape[1]
        sin, cos = self._rope(torch.arange(S, device=x.device))
        for i, p in enumerate(self.layers):
            x = block_apply(p.tree(), x, cfg.block_at(i), cfg, self.policy, sin, cos)
        return self._head(x), torch.zeros((), dtype=torch.float32, device=x.device)

    # --- decode ----------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> List[Dict]:
        """One ring-buffer KV cache per layer, in the compute dtype."""
        return [block_cache_init(self.cfg, self.cfg.block_at(i), batch, seq_len, self.device)
                for i in range(self.cfg.num_layers)]

    @torch.no_grad()
    def decode_step(self, cache: List[Dict], tokens: torch.Tensor, pos: int,
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens (B, 1) int; pos the position of this step.  Returns
        (logits (B, 1, V), the new cache)."""
        cfg = self.cfg
        x = self._embed(tokens)
        sin, cos = self._rope(torch.full((1,), int(pos), device=x.device))
        new_cache: List[Optional[Dict]] = []
        for i, p in enumerate(self.layers):
            x, c = block_decode_step(p.tree(), x, cache[i], cfg.block_at(i), cfg, self.policy,
                                     int(pos), sin, cos)
            new_cache.append(c)
        return self._head(x), new_cache
