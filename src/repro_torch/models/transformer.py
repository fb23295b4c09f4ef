"""Model assembly (``repro.models.transformer``): the decoder and
encoder-decoder families, full-sequence forward and single-token decode with
typed caches.

``Model`` is an ``nn.Module`` holding one parameter tree per layer; layers run
as a Python loop over them (the reference stacks the layers of each pattern
period and scans over the stack).  A layer's mixer is attention (a ring-buffer
KV cache) or one of the recurrent mixers of ``models.ssm``, Mamba, mLSTM or
sLSTM (a state of fixed size); its MLP is dense, MoE (``models.moe``) or none.
The ``encdec`` family (whisper) adds an encoder of non-causal attention blocks
over frame embeddings (``encoder.{i}``, ``enc_norm``, ``enc_pos``) and a
cross-attention in every decoder layer; its decode attends over a cross cache
of zeros, as the reference's does (ROADMAP queue 3, item 16).  ``rope_type``
"mrope" (qwen2-vl) takes three position streams (B, 3, S) with the embeddings.

Parameters are registered frozen, so a served forward records no graph;
training unfreezes them (``model.requires_grad_(True)``,
``train.loop.make_train_step``).  Under autograd with ``cfg.remat`` each layer
runs in a non-reentrant ``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` per pattern period: per layer or per period, the values are
the same.  The recompute runs under the forward's dispatch and telemetry
modes, since a CUDA backward runs on a thread of its own (``core.policy``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.core import dispatch
from repro_torch.core.policy import Policy
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.obs import telemetry as obs


# The recurrent mixer kinds: ``models.ssm`` names each one's functions
# ``<kind>_init``, ``<kind>_apply``, ``<kind>_state_init`` and ``<kind>_decode_step``.
RECURRENT = ("mamba", "mlstm", "slstm")


def _recurrent(blk: BlockCfg, fn: str):
    return getattr(ssm, f"{blk.mixer}_{fn}")


# The encoder's layers: attention with a dense MLP, no cross-attention.
ENC_BLOCK = BlockCfg(mixer="attn", mlp="dense")


def _check_block(cfg: ModelConfig, blk: BlockCfg) -> None:
    if cfg.family not in ("decoder", "encdec"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if blk.mixer != "attn" and blk.mixer not in RECURRENT:
        raise ValueError(f"{cfg.name}: unknown mixer {blk.mixer!r}")
    if blk.mlp not in ("dense", "moe", "none"):
        raise ValueError(f"{cfg.name}: unknown mlp {blk.mlp!r}")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, blk: BlockCfg,
               decoder: bool = True) -> Dict:
    """norm1 and the mixer; in an encoder-decoder's decoder layer norm_cross and
    the cross-attention; norm2 and the MLP unless the block has none."""
    _check_block(cfg, blk)
    dt = cfg.param_torch_dtype
    p = {"norm1": layers.rmsnorm_init(cfg.d_model, dt, gen.device),
         "mixer": (attention.attn_init(gen, cfg) if blk.mixer == "attn" else
                   _recurrent(blk, "init")(gen, cfg))}
    if cfg.family == "encdec" and decoder:
        p["norm_cross"] = layers.rmsnorm_init(cfg.d_model, dt, gen.device)
        p["cross"] = attention.attn_init(gen, cfg, cross=True)
    if blk.mlp != "none":
        p["norm2"] = layers.rmsnorm_init(cfg.d_model, dt, gen.device)
        p["mlp"] = (moe.moe_init(gen, cfg) if blk.mlp == "moe" else
                    layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, act=cfg.mlp_act))
    return p


def _mlp(p: Dict, x: torch.Tensor, blk: BlockCfg, cfg: ModelConfig, policy: Policy
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x after the block's MLP, and its aux loss (0 but for an MoE MLP)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if blk.mlp == "none":
        return x, zero
    h = layers.rmsnorm_apply(p["norm2"], x)
    if blk.mlp == "moe":
        mo, aux = moe.moe_apply(p["mlp"], h, cfg, policy)
        return x + mo, aux
    return x + layers.mlp_apply(p["mlp"], h, policy, cfg.mlp_act), zero


def block_apply(p: Dict, x: torch.Tensor, blk: BlockCfg, cfg: ModelConfig, policy: Policy,
                sin, cos, enc_out: Optional[torch.Tensor] = None,
                causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, aux loss) after the block; a decoder layer with a cross-attention
    attends to ``enc_out`` after its mixer."""
    h = layers.rmsnorm_apply(p["norm1"], x)
    if blk.mixer == "attn":
        mo = attention.attn_apply(p["mixer"], h, cfg, policy, sin, cos, window=blk.window,
                                  causal=causal)
    else:
        mo = _recurrent(blk, "apply")(p["mixer"], h, cfg, policy)
    x = x + mo
    if enc_out is not None and "cross" in p:
        hc = layers.rmsnorm_apply(p["norm_cross"], x)
        x = x + attention.cross_attn_apply(p["cross"], hc, enc_out, cfg, policy)
    return _mlp(p, x, blk, cfg, policy)


def block_cache_init(cfg: ModelConfig, blk: BlockCfg, batch: int, seq_len: int,
                     device, enc_seq: int = 0) -> Dict:
    """An attention layer's KV cache ``{"kv": ...}``, or a recurrent mixer's
    state ``{"ssm": ...}``; in an encoder-decoder with ``enc_seq`` frames also
    the cross cache ``{"cross_kv": ...}``, zeros of (batch, enc_seq, Hkv, D) in
    the compute dtype."""
    if blk.mixer == "attn":
        c = {"kv": attention.cache_init(cfg, batch, seq_len, blk.window, device=device)}
    else:
        c = {"ssm": _recurrent(blk, "state_init")(cfg, batch, device)}
    if cfg.family == "encdec" and enc_seq:
        shape = (batch, enc_seq, cfg.num_kv_heads, cfg.head_dim)
        dt = cfg.compute_torch_dtype
        c["cross_kv"] = {"k": torch.zeros(shape, dtype=dt, device=device),
                         "v": torch.zeros(shape, dtype=dt, device=device)}
    return c


def block_decode_step(p: Dict, x: torch.Tensor, cache: Dict, blk: BlockCfg, cfg: ModelConfig,
                      policy: Policy, pos: int, sin, cos) -> Tuple[torch.Tensor, Dict]:
    new_cache = dict(cache)
    h = layers.rmsnorm_apply(p["norm1"], x)
    if blk.mixer == "attn":
        mo, new_cache["kv"] = attention.attn_decode_step(p["mixer"], h, cache["kv"], pos, cfg,
                                                         policy, sin, cos, window=blk.window)
    else:
        mo, new_cache["ssm"] = _recurrent(blk, "decode_step")(p["mixer"], h, cache["ssm"], cfg,
                                                              policy)
    x = x + mo
    if "cross_kv" in cache and "cross" in p:
        hc = layers.rmsnorm_apply(p["norm_cross"], x)
        x = x + attention.cross_decode_step(p["cross"], hc, cache["cross_kv"], cfg, policy)
    x, _ = _mlp(p, x, blk, cfg, policy)
    return x, new_cache


@contextlib.contextmanager
def recompute_scope(modes: Tuple[str, str]):
    """The dispatch and telemetry ``modes`` of a checkpointed layer's forward,
    restored around its recompute in the backward."""
    with dispatch.mode_scope(modes[0]), obs.telemetry_scope(modes[1]):
        yield


def _layer_runner(checkpointed: bool):
    """Call a layer's function directly, or through a checkpoint whose
    recompute sees the forward's modes."""
    if not checkpointed:
        return lambda fn, *args: fn(*args)
    modes = (dispatch.get_mode(), obs.get_mode())

    def contexts():
        return contextlib.nullcontext(), recompute_scope(modes)

    return lambda fn, *args: checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                   context_fn=contexts)


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
    """A model over ``cfg``: ``embed``, ``layers.{i}``, ``final_norm`` and
    ``lm_head`` (absent with tied embeddings); an encoder-decoder also
    ``encoder.{i}``, ``enc_norm`` and ``enc_pos``.  Build its weights with
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
        if cfg.family == "encdec":
            tree["encoder"] = {str(i): block_init(gen, cfg, ENC_BLOCK, decoder=False)
                               for i in range(cfg.encoder_layers)}
            tree["enc_norm"] = layers.rmsnorm_init(cfg.d_model, dt, gen.device)
            tree["enc_pos"] = torch.empty((cfg.encoder_seq, cfg.d_model), dtype=dt,
                                          device=gen.device).normal_(generator=gen) * 0.02
        return self._set(tree)

    def load(self, state: Dict[str, torch.Tensor]) -> "Model":
        """Weights from a flat state dict (``convert.params_from_jax`` makes one)."""
        return self._set(_unflatten(state))

    def _set(self, tree: Dict[str, Any]) -> "Model":
        cfg = self.cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.layers = nn.ModuleList(ParamTree(tree["layers"][str(i)])
                                    for i in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree(tree["lm_head"])
        if cfg.family == "encdec":
            self.encoder = nn.ModuleList(ParamTree(tree["encoder"][str(i)])
                                         for i in range(cfg.encoder_layers))
            self.enc_norm = ParamTree(tree["enc_norm"])
            self.enc_pos = nn.Parameter(tree["enc_pos"], requires_grad=False)
        return self

    def stacked_groups(self) -> List[List[str]]:
        """The parameter names that the reference holds as one stacked leaf,
        in groups of two or more: the same block's tensor in every pattern
        period (``layers.{i * period + j}``, i over the periods), and every
        encoder layer's.  Tail layers and the other parameters are leaves of
        their own."""
        cfg = self.cfg
        stacked = cfg.num_periods * cfg.period
        groups: Dict[Tuple, List[str]] = {}
        for name, _ in self.named_parameters():
            part, _, rest = name.partition(".")
            if part == "layers" and int(rest.split(".")[0]) < stacked:
                i, _, leaf = rest.partition(".")
                groups.setdefault(("layers", int(i) % cfg.period, leaf), []).append(name)
            elif part == "encoder":
                groups.setdefault(("encoder", rest.partition(".")[2]), []).append(name)
        return [names for names in groups.values() if len(names) > 1]

    # --- shared pieces --------------------------------------------------------

    def _remat(self, x: torch.Tensor) -> bool:
        """Whether to checkpoint the layers: ``cfg.remat`` while autograd
        records this forward."""
        return self.cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def _rope(self, positions: torch.Tensor, batch: Optional[int] = None):
        """(sin, cos) for ``positions``: (S,) for every rope type, or (B, 3, S)
        M-RoPE streams; text-only positions give M-RoPE three equal streams."""
        cfg = self.cfg
        if cfg.rope_type == "none":
            z = torch.zeros((positions.shape[-1], cfg.head_dim // 2), device=positions.device)
            return z, 1.0 + z
        if cfg.rope_type == "mrope":
            if positions.ndim == 1:
                positions = positions[None, None, :].expand(batch or 1, 3, positions.shape[0])
            return layers.mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                                       cfg.mrope_sections)
        if cfg.rope_type != "standard":
            raise ValueError(f"{cfg.name}: unknown rope_type {cfg.rope_type!r}")
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

    def _encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder over frame embeddings (B, T, d): ``enc_pos`` added,
        non-causal attention blocks with RoPE over arange(T), ``enc_norm``."""
        cfg = self.cfg
        x = enc_embeds.to(cfg.compute_torch_dtype)
        x = x + self.enc_pos.to(x.dtype)[None, :x.shape[1]]
        sin, cos = self._rope(torch.arange(x.shape[1], device=x.device))
        run = _layer_runner(self._remat(x))
        for p in self.encoder:
            x, _ = run(lambda x, p=p: block_apply(p.tree(), x, ENC_BLOCK, cfg, self.policy, sin,
                                                  cos, causal=False), x)
        return layers.rmsnorm_apply(self.enc_norm.tree(), x)

    # --- forward (prefill) ------------------------------------------------------

    def apply(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {"tokens" (B, S) int | "embeds" (B, S, d)} [+ "positions" (B, 3,
        S) for M-RoPE, "enc_embeds" (B, T, d) for an encoder-decoder]; returns
        (logits float32 (B, S, V), the layers' summed aux loss).  Differentiable
        in the parameters once they are unfrozen; each layer is checkpointed
        under ``cfg.remat``.  The layers run as a Python loop, which is the
        reference's ``cfg.force_unroll`` loop: that field changes nothing here."""
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(cfg.compute_torch_dtype)
        else:
            x = self._embed(batch["tokens"])
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device)
        sin, cos = self._rope(positions, batch=B)
        enc_out = self._encode(batch["enc_embeds"]) if cfg.family == "encdec" else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        run = _layer_runner(self._remat(x))
        for i, p in enumerate(self.layers):
            x, a = run(lambda x, enc_out, p=p, i=i: block_apply(
                p.tree(), x, cfg.block_at(i), cfg, self.policy, sin, cos, enc_out=enc_out),
                x, enc_out)
            aux = aux + a
        return self._head(x), aux

    # --- decode ----------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int) -> List[Dict]:
        """A cache per layer: a ring-buffer KV cache in the compute dtype
        (attention), or a float32 state (the recurrent mixers); an
        encoder-decoder's layers also hold a cross cache of zeros."""
        return [block_cache_init(self.cfg, self.cfg.block_at(i), batch, seq_len, self.device,
                                 enc_seq=self.cfg.encoder_seq)
                for i in range(self.cfg.num_layers)]

    @torch.no_grad()
    def decode_step(self, cache: List[Dict], tokens: torch.Tensor, pos: int,
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens (B, 1) int; pos the position of this step.  Returns
        (logits (B, 1, V), the new cache); MoE aux losses are dropped, as in
        the reference."""
        cfg = self.cfg
        x = self._embed(tokens)
        sin, cos = self._rope(torch.full((1,), int(pos), device=x.device), batch=x.shape[0])
        new_cache: List[Optional[Dict]] = []
        for i, p in enumerate(self.layers):
            x, c = block_decode_step(p.tree(), x, cache[i], cfg.block_at(i), cfg, self.policy,
                                     int(pos), sin, cos)
            new_cache.append(c)
        return self._head(x), new_cache
