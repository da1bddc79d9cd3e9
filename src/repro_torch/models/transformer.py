"""Decoder LM for serving (mirrors ``repro/models/transformer.py``).

Per-layer weights are a Python list under ``params["blocks"]`` where the
reference stacks them on a leading layer axis and scans. Any 2-D GEMM
weight may be a ``PackedTensor``; ``dense_apply`` then runs it through the
packed kernel. The serving prefill asks for the ``flash_attention``
kernel (``use_flash``), which takes the shapes ``flash_prefill_supported``
admits on the card; every other call, and every training forward (the
kernel has no backward, as the reference's has none), runs
``blockwise_attention``. ``hidden_states``, ``block`` and ``train_loss``
carry autograd; ``init``, ``prefill`` and decode run under
``torch.no_grad``. ``verify_chunk``, ``cache_snapshot`` and
``cache_rollback`` are the speculative engine's chunked verify and rewind.
A MoE config (``num_experts``) runs ``models/moe.py`` in place of the FFN
in every path; its routed experts stay dense (E, D, F) leaves, and
``train_loss`` adds the reference's load-balancing term. A
``sliding_window`` model attends to the last ``window`` positions in
every forward and serves from a ring cache (``_cache_ring``). The two
embedding-input families, ``vlm`` (pixtral) and ``audio`` (hubert), take
(B, S, D) embeddings from their stub front ends, so their trees have no
``embed`` table; an encoder-only config (``causal=False``) attends both
ways in every full-sequence forward.

The recurrent families run ``models/ssm.py``. ``hybrid`` (hymba) runs
mamba heads beside attention in every block, the mixer the mean of the
two, and its cache carries each layer's mamba state (``mamba/h``,
``mamba/conv``) beside the KV rows. ``ssm`` (xLSTM) stacks its blocks in
G groups of ``slstm_every - 1`` mLSTM blocks and one sLSTM block:
``params["blocks"]`` is a list of G groups, each ``{"mlstm": leaves with
a leading (slstm_every - 1) axis, "slstm": leaves}``, as the reference
stacks them (G, per - 1, ...) and (G, ...); its cache is the recurrent
states alone, fp32, in the reference's stacked layout, and no KV rows.
Every recurrent state is written IN PLACE, so a captured decode graph
replays on the same tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (
    cache_capacity,
    cache_insert,
    cache_insert_chunk,
    chunk_attention,
    chunk_slots,
    decode_attention,
    insert_slots,
    prefill_attention,
    slot_prompt_rows,
)
from repro_torch.models.layers import (
    apply_rope_tables,
    dense_apply,
    dense_init,
    dtype_of,
    embed_init,
    ffn_apply,
    ffn_init,
    rmsnorm,
    rmsnorm_init,
    rope_tables,
)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.utils.tree import tree_items, tree_map

LOSS_CHUNK = 512               # sequence positions per cross-entropy chunk
MOE_AUX_COEF = 0.01
PORTED_FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def xlstm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(G groups, blocks per group) of an xLSTM config: each group is
    ``per - 1`` mLSTM blocks then one sLSTM block."""
    per = cfg.slstm_every if cfg.slstm_every else cfg.num_layers
    if cfg.num_layers % per != 0:
        raise ValueError("num_layers must divide by slstm_every")
    return cfg.num_layers // per, per


def _cell(bp: Dict[str, Any]) -> Dict[str, Any]:
    """A recurrent block's cell params: its tree without the norm."""
    return {k: v for k, v in bp.items() if k != "norm"}


def _write_state(bufs: Dict[str, torch.Tensor], state: Dict[str, Any],
                 at: Tuple[Any, ...] = ()) -> None:
    """Copy each of ``state``'s tensors into ``bufs[k][at]`` in place."""
    for k, t in state.items():
        bufs[k][at].copy_(t)


class LM:
    """The reference's ``LM`` for every family, on one device."""

    def __init__(self, config: ModelConfig, *, device: DeviceLike = None):
        if config.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family '{config.family}'")
        if config.family == "ssm":
            xlstm_groups(config)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype_of(config.param_dtype)

    # ------------------------------------------------------------------ init

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """'/'-path -> shape of every parameter ``init`` creates."""
        cfg = self.config
        D = cfg.d_model
        block = {"norm1/scale": (D,), "attn/wq": (D, cfg.attn_dim),
                 "attn/wk": (D, cfg.kv_dim), "attn/wv": (D, cfg.kv_dim),
                 "attn/wo": (cfg.attn_dim, D), "norm2/scale": (D,)}
        if cfg.qkv_bias:
            block.update({"attn/bq": (cfg.attn_dim,), "attn/bk": (cfg.kv_dim,),
                          "attn/bv": (cfg.kv_dim,)})
        if cfg.num_experts:
            E, F = cfg.num_experts, cfg.expert_d_ff
            block.update({"moe/router": (D, E),
                          "moe/experts/w_gate": (E, D, F),
                          "moe/experts/w_up": (E, D, F),
                          "moe/experts/w_down": (E, F, D)})
            if cfg.num_shared_experts:
                Fs = cfg.num_shared_experts * F
                block.update({"moe/shared/w_gate": (D, Fs),
                              "moe/shared/w_up": (D, Fs),
                              "moe/shared/w_down": (Fs, D)})
        elif cfg.d_ff:
            names = (("w_gate", "w_up", "w_down") if cfg.ffn_type == "swiglu"
                     else ("w_up", "w_down"))
            for n in names:
                block[f"mlp/{n}"] = ((cfg.d_ff, D) if n == "w_down"
                                     else (D, cfg.d_ff))
        if cfg.family == "hybrid":
            di, N = cfg.mamba_heads * cfg.mamba_head_dim, cfg.ssm_state
            block.update({"mamba/w_in": (D, 2 * di),
                          "mamba/conv_w": (cfg.conv_kernel, di),
                          "mamba/w_bcdt": (di, 2 * N + 1),
                          "mamba/a_log": (di, N), "mamba/d_skip": (di,),
                          "mamba/dt_bias": (1,), "mamba/w_out": (di, D)})
        shapes = {"final_norm/scale": (D,)}
        if self.takes_tokens:
            shapes["embed"] = (cfg.vocab_size, D)
        if cfg.family == "ssm":
            shapes.update(self._xlstm_shapes())
        else:
            for layer in range(cfg.num_layers):
                shapes.update({f"blocks/{layer}/{k}": v
                               for k, v in block.items()})
        if self.has_lm_head:
            shapes["lm_head"] = (D, cfg.vocab_size)
        return shapes

    def _xlstm_shapes(self) -> Dict[str, Tuple[int, ...]]:
        cfg = self.config
        D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        di = H * hd
        G, per = xlstm_groups(cfg)
        m = {"w_up": (D, 2 * di), "conv_w": (cfg.conv_kernel, di),
             "wq": (di, di), "wk": (di, di), "wv": (di, di),
             "w_if": (di, 2 * H), "b_if": (2 * H,), "w_down": (di, D),
             "out_norm_scale": (di,), "norm/scale": (D,)}
        sl = {"w_gates": (D, 4 * D), "r_gates": (H, D // H, 4 * D // H),
              "b_gates": (4 * D,), "w_out": (D, D), "norm/scale": (D,)}
        shapes = {}
        for g in range(G):
            shapes.update({f"blocks/{g}/mlstm/{k}": (per - 1,) + v
                           for k, v in m.items()})
            shapes.update({f"blocks/{g}/slstm/{k}": v for k, v in sl.items()})
        return shapes

    @property
    def takes_tokens(self) -> bool:
        """Token ids in, through an ``embed`` table; else (B, S, D)
        embeddings from a stub front end, and no table."""
        return self.config.input_kind == "tokens"

    @property
    def has_lm_head(self) -> bool:
        # an embedding-input model has no table to tie its head to
        return not (self.config.tie_embeddings and self.takes_tokens)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights drawn from ``gen`` (a generator on this device)."""
        cfg, dt, dev = self.config, self.dtype, self.device
        params: Dict[str, Any] = {}
        if self.takes_tokens:
            params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                         dt, dev)
        if cfg.family == "ssm":
            params["blocks"] = self._init_xlstm_blocks(gen)
        else:
            params["blocks"] = [self._init_block(gen)
                                for _ in range(cfg.num_layers)]
        params["final_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
        if self.has_lm_head:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           dt, dev)
        return params

    def _init_block(self, gen: torch.Generator) -> Dict[str, Any]:
        cfg, dt, dev = self.config, self.dtype, self.device
        attn = {"wq": dense_init(gen, cfg.d_model, cfg.attn_dim, dt, dev),
                "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, dev),
                "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, dev),
                "wo": dense_init(gen, cfg.attn_dim, cfg.d_model, dt, dev)}
        if cfg.qkv_bias:
            for name, width in (("bq", cfg.attn_dim), ("bk", cfg.kv_dim),
                                ("bv", cfg.kv_dim)):
                attn[name] = torch.zeros((width,), dtype=dt, device=dev)
        block = {"norm1": rmsnorm_init(cfg.d_model, dt, dev), "attn": attn,
                 "norm2": rmsnorm_init(cfg.d_model, dt, dev)}
        if cfg.num_experts:
            block["moe"] = moe_init(gen, cfg.d_model, cfg.num_experts,
                                    cfg.num_shared_experts,
                                    cfg.expert_d_ff, dt, dev)
        elif cfg.d_ff:
            block["mlp"] = ffn_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.ffn_type, dt, dev)
        if cfg.family == "hybrid":
            block["mamba"] = ssm_mod.mamba_init(
                gen, cfg.d_model, cfg.mamba_heads * cfg.mamba_head_dim,
                cfg.ssm_state, cfg.conv_kernel, dt, dev)
        return block

    def _init_xlstm_blocks(self, gen: torch.Generator) -> List[Any]:
        """G groups: ``per - 1`` mLSTM blocks stacked on a leading axis,
        then one sLSTM block, each block with its own norm."""
        cfg, dt, dev = self.config, self.dtype, self.device
        G, per = xlstm_groups(cfg)

        def m_block():
            return {**ssm_mod.mlstm_init(gen, cfg.d_model, cfg.num_heads,
                                         cfg.head_dim, cfg.conv_kernel, dt,
                                         dev),
                    "norm": rmsnorm_init(cfg.d_model, dt, dev)}

        groups = []
        for _ in range(G):
            ms = [m_block() for _ in range(per - 1)]
            groups.append({
                "mlstm": tree_map(lambda *ts: torch.stack(ts), *ms),
                "slstm": {**ssm_mod.slstm_init(gen, cfg.d_model,
                                               cfg.num_heads, dt, dev),
                          "norm": rmsnorm_init(cfg.d_model, dt, dev)}})
        return groups

    # --------------------------------------------------------------- forward

    def embed_inputs(self, params, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids (B, S) through the table, or (B, S, D) embeddings cast
        to the parameter dtype."""
        if self.takes_tokens:
            return params["embed"][inputs]
        if inputs.ndim != 3 or inputs.shape[-1] != self.config.d_model:
            raise ValueError(
                f"{self.config.name} takes (B, S, {self.config.d_model}) "
                f"embeddings from its front end, got shape "
                f"{tuple(inputs.shape)}")
        return inputs.to(self.dtype)

    def _qkv(self, bp, h: torch.Tensor, sin, cos):
        cfg = self.config
        attn_p = bp["attn"]
        # the qkv bias rides the GEMM epilogue (fused in-kernel when packed)
        q = dense_apply(h, attn_p["wq"], bias=attn_p.get("bq"))
        k = dense_apply(h, attn_p["wk"], bias=attn_p.get("bk"))
        v = dense_apply(h, attn_p["wv"], bias=attn_p.get("bv"))
        B, S, _ = h.shape
        q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        return apply_rope_tables(q, sin, cos), apply_rope_tables(k, sin, cos), v

    def _mlp(self, bp, x: torch.Tensor, aux: Optional[list] = None
             ) -> torch.Tensor:
        """The channel mixer and its residual: MoE, the FFN or nothing.
        ``aux``, a list, gets a MoE layer's load-balancing loss."""
        cfg = self.config
        h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
        if cfg.num_experts:
            y, layer_aux = moe_apply(bp["moe"], h, top_k=cfg.moe_top_k,
                                     capacity_factor=cfg.capacity_factor)
            if aux is not None:
                aux.append(layer_aux)
        elif cfg.d_ff:
            y = ffn_apply(bp["mlp"], h, cfg.ffn_type)
        else:
            y = 0
        return x + y

    def rope(self, S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sin, cos) rotary tables of positions 0 .. S - 1."""
        positions = torch.arange(S, dtype=torch.int32, device=device)
        return rope_tables(positions, self.config.head_dim,
                           self.config.rope_theta)

    def block(self, bp, x: torch.Tensor, rope, *, use_flash: bool = False,
              kv: Optional[list] = None,
              aux: Optional[list] = None) -> torch.Tensor:
        """One block over the full sequence (the reference's
        ``_mixer_and_mlp``): the sequence mixer and its residual, then the
        MLP and its residual. The mixer is attention, or for the hybrid
        family the mean of attention and the mamba heads, both on the same
        normed input. ``use_flash`` asks for the flash kernel (serving
        only: it has no backward); ``kv``, a list, gets this layer's
        (k, v) appended, and a hybrid layer's final mamba state as a
        third entry; ``aux``, a list, its MoE load-balancing loss."""
        cfg = self.config
        B, S, _ = x.shape
        h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
        q, k, v = self._qkv(bp, h, *rope)
        out = prefill_attention(q, k, v, causal=cfg.causal,
                                window=cfg.sliding_window,
                                use_flash=use_flash)
        mixer = dense_apply(out.reshape(B, S, cfg.attn_dim), bp["attn"]["wo"])
        entry: Tuple[Any, ...] = (k, v)
        if cfg.family == "hybrid":
            if kv is not None:
                m_out, state = ssm_mod.mamba_apply(bp["mamba"], h,
                                                   return_state=True)
                entry += (state,)
            else:
                m_out = ssm_mod.mamba_apply(bp["mamba"], h)
            mixer = 0.5 * (mixer + m_out)
        if kv is not None:
            kv.append(entry)
        return self._mlp(bp, x + mixer, aux)

    def hidden_states(self, params, tokens: torch.Tensor, *,
                      collect_kv: bool = False, use_flash: bool = False,
                      aux: Optional[list] = None):
        """Full-sequence forward -> (final-normed hidden (B, S, D), kv).

        ``kv`` is a per-layer list of (k, v), each (B, S, KV, hd) (a
        hybrid layer's with its final mamba state third), when
        ``collect_kv``; else None, and always None for an xLSTM.
        ``use_flash`` is for serving paths. ``aux``, a list, gets each MoE
        layer's load-balancing loss (the reference returns their sum
        beside the hidden states).
        """
        cfg = self.config
        x = self.embed_inputs(params, tokens)
        if cfg.family == "ssm":
            x, _ = self._xlstm_forward(params["blocks"], x)
            return rmsnorm(params["final_norm"], x, cfg.norm_eps), None
        rope = self.rope(x.shape[1], x.device)
        kv: Optional[List[Tuple[torch.Tensor, ...]]] = (
            [] if collect_kv else None)
        for bp in params["blocks"]:
            x = self.block(bp, x, rope, use_flash=use_flash, kv=kv, aux=aux)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), kv

    def _xlstm_forward(self, blocks, x: torch.Tensor, *,
                       return_states: bool = False):
        """The xLSTM groups over x (B, S, D) -> (x, states): with
        ``return_states`` each group's ``{"mlstm": [state per block],
        "slstm": state}`` (prefill), else None."""
        cfg = self.config
        H = cfg.num_heads
        states = [] if return_states else None
        for gp in blocks:
            mst = []
            for i in range(gp["mlstm"]["w_up"].shape[0]):
                bp = tree_map(lambda t, i=i: t[i], gp["mlstm"])
                h = rmsnorm(bp["norm"], x, cfg.norm_eps)
                out = ssm_mod.mlstm_apply(_cell(bp), h, num_heads=H,
                                          return_state=return_states)
                if return_states:
                    out, st = out
                    mst.append(st)
                x = x + out
            bp = gp["slstm"]
            h = rmsnorm(bp["norm"], x, cfg.norm_eps)
            out = ssm_mod.slstm_apply(_cell(bp), h, num_heads=H,
                                      return_state=return_states)
            if return_states:
                out, sst = out
                states.append({"mlstm": mst, "slstm": sst})
            x = x + out
        return x, states

    def lm_head_weight(self, params):
        return params["lm_head"] if "lm_head" in params else params["embed"].T

    def lm_logits(self, params, h: torch.Tensor) -> torch.Tensor:
        return dense_apply(h, self.lm_head_weight(params))

    def train_loss(self, params, batch: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        """Mean next-token cross-entropy of ``{"inputs", "labels"}``, the
        logits taken ``LOSS_CHUNK`` positions at a time and recomputed in
        the backward pass (the reference's checkpointed chunks), so the
        (B, S, vocab) logits never exist at once. A MoE model adds
        ``MOE_AUX_COEF`` times its layers' mean load-balancing loss."""
        cfg = self.config
        aux: List[torch.Tensor] = []
        h, _ = self.hidden_states(params, batch["inputs"], aux=aux)
        labels = batch["labels"]
        B, S, _ = h.shape
        w = self.lm_head_weight(params)
        c = min(LOSS_CHUNK, S)

        def chunk_nll(h_c, y_c):
            logits = torch.einsum("bcd,dv->bcv", h_c, w).to(torch.float32)
            gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
            return (torch.logsumexp(logits, dim=-1) - gold).sum()

        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(S // c):
            total = total + checkpoint(chunk_nll, h[:, i * c:(i + 1) * c],
                                       labels[:, i * c:(i + 1) * c],
                                       use_reentrant=False)
        loss = total / (B * S)
        if cfg.num_experts:
            aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
            for a in aux:                  # in layer order, as the scan adds
                aux_sum = aux_sum + a
            loss = loss + MOE_AUX_COEF * aux_sum / cfg.num_layers
        return loss

    # --------------------------------------------------------------- serving

    def init_cache(self, batch: int, seq_len: int) -> Dict[str, Any]:
        """Zeroed decode cache: per-layer k/v lists, slot positions, write
        pos; a hybrid model's mamba states beside them, (L, B, ...) fp32;
        an xLSTM's recurrent states alone, in the reference's stacked
        (G, per - 1, B, ...) and (G, B, ...) layout, fp32 (zeros, as the
        reference's ``init_cache``)."""
        cfg, dev = self.config, self.device
        f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                         device=dev)
        pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if cfg.family == "ssm":
            G, per = xlstm_groups(cfg)
            H, hd, D = cfg.num_heads, cfg.head_dim, cfg.d_model
            lead = (G, per - 1, batch)
            return {"mlstm": {"C": f32(*lead, H, hd, hd),
                              "n": f32(*lead, H, hd), "m": f32(*lead, H),
                              "conv": f32(*lead, cfg.conv_kernel - 1,
                                          H * hd)},
                    "slstm": {k: f32(G, batch, D) for k in "chnm"},
                    "pos": pos}
        C = cache_capacity(seq_len, cfg.sliding_window).capacity
        shape = (batch, C, cfg.num_kv_heads, cfg.head_dim)
        zeros = lambda: torch.zeros(shape, dtype=self.dtype, device=dev)
        cache = {"k": [zeros() for _ in range(cfg.num_layers)],
                 "v": [zeros() for _ in range(cfg.num_layers)],
                 "slot_pos": torch.full((batch, C), -1, dtype=torch.int32,
                                        device=dev),
                 "pos": pos}
        if cfg.family == "hybrid":
            L, di = cfg.num_layers, cfg.mamba_heads * cfg.mamba_head_dim
            cache["mamba"] = {"h": f32(L, batch, di, cfg.ssm_state),
                              "conv": f32(L, batch, cfg.conv_kernel - 1, di)}
        return cache

    def cache_seq_len(self, cache: Dict[str, Any]) -> int:
        """A ``seq_len`` whose ``init_cache`` has ``cache``'s shapes (an
        xLSTM's cache has no positions: any)."""
        return cache["slot_pos"].shape[1] if "slot_pos" in cache else 1

    def reset_cache(self, cache: Dict[str, Any]) -> None:
        """Clear ``cache`` IN PLACE to ``init_cache``'s values."""
        for name, t in tree_items(cache):
            t.fill_(-1 if name == "slot_pos" else 0)

    def _cache_ring(self, cache: Dict[str, Any]) -> bool:
        """The decode-side ring rule: a cache rings iff a sliding window
        bounds its capacity (C <= window). ``prefill`` follows the
        reference's other rule, a ring iff ``window < seq_len``; so a
        windowed model served at ``seq_len <= window`` prefills a full
        cache and decodes it as a ring, a position past C wrapping."""
        w = self.config.sliding_window
        return w is not None and cache["slot_pos"].shape[1] <= w

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, seq_len: int,
                cache: Optional[Dict[str, Any]] = None):
        """Run the prompt, tokens (B, S) or embeddings (B, S, D), build the
        cache -> (cache, last-token logits).

        With ``cache`` (one of ``init_cache(B, seq_len)``) the prompt is
        written into it IN PLACE (slots past the prompt marked empty)
        instead of a new one: a captured decode graph keeps reading the
        same tensors. A ring cache keeps the prompt's last C positions,
        position p in slot p % C; a full one refuses a prompt past C. A
        hybrid model writes each layer's final mamba state too; an xLSTM
        writes its recurrent states alone (``_xlstm_prefill``).
        """
        B, S = tokens.shape[:2]
        if cache is None:
            cache = self.init_cache(B, seq_len)
        if self.config.family == "ssm":
            return self._xlstm_prefill(params, tokens, cache)
        C = cache["slot_pos"].shape[1]
        ring = cache_capacity(seq_len, self.config.sliding_window).ring
        rows, keep, sp_row = slot_prompt_rows(C, S, ring,
                                              device=tokens.device)
        h, kv = self.hidden_states(params, tokens, collect_kv=True,
                                   use_flash=True)
        for layer, (k, v, *mamba) in enumerate(kv):
            for name, new in (("k", k), ("v", v)):
                cache[name][layer].index_copy_(1, rows.long(),
                                               new[:, S - keep:])
            if mamba:
                _write_state(cache["mamba"], mamba[0], (layer,))
        cache["slot_pos"].copy_(sp_row.expand(B, C))
        cache["pos"].fill_(S)
        return cache, self.lm_logits(params, h[:, -1:, :])

    def _xlstm_prefill(self, params, tokens: torch.Tensor,
                       cache: Dict[str, Any]):
        """One forward collecting every block's final recurrent state,
        written into ``cache`` IN PLACE -> (cache, last-token logits)."""
        cfg = self.config
        x, states = self._xlstm_forward(params["blocks"],
                                        self.embed_inputs(params, tokens),
                                        return_states=True)
        for g, st in enumerate(states):
            for i, mst in enumerate(st["mlstm"]):
                _write_state(cache["mlstm"], mst, (g, i))
            _write_state(cache["slstm"], st["slstm"], (g,))
        cache["pos"].fill_(tokens.shape[1])
        h = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        return cache, self.lm_logits(params, h)

    @torch.no_grad()
    def prefill_into_slot(self, params, cache: Dict[str, Any],
                          prompt: torch.Tensor, slot):
        """Prefill ONE prompt (1, S) (or embeddings (1, S, D)) into ONE
        slot of a LIVE decode cache
        -> (cache, last-token logits (1, 1, V)).

        ``slot``: a Python int or a one-element int64 tensor on the
        cache's device (a captured graph reads it from a static buffer,
        so one graph per S serves every slot). The prompt runs as a solo
        forward (positions 0 .. S - 1, no batch-mates, no padding;
        through ``flash_attention`` on the card), and only the slot's rows
        change: its k/v rows of the prompt's positions (on a ring the last
        C, position p in slot p % C), its ``slot_pos`` row (fresh
        positions where written, -1 elsewhere, so a retired occupant's
        stale KV is masked out) and its ``pos`` entry (set to S), and a
        hybrid model's mamba state rows. Every other row stays untouched,
        and everything is written IN PLACE into the same tensors (a
        captured decode graph reads them). An xLSTM raises
        ``NotImplementedError``, as the reference's does.
        """
        if self.config.family == "ssm":
            raise NotImplementedError(
                "prefill_into_slot needs a KV-cache family; xLSTM "
                "recurrent-state slot admission is not implemented")
        S = prompt.shape[1]
        dev = cache["pos"].device
        rows, keep, sp_row = slot_prompt_rows(
            cache["slot_pos"].shape[1], S, self._cache_ring(cache),
            device=dev)
        idx = (slot.view(1) if isinstance(slot, torch.Tensor)
               else torch.tensor([slot], dtype=torch.int64, device=dev))
        at = (idx.expand(keep), rows.long())
        h, kv = self.hidden_states(params, prompt, collect_kv=True,
                                   use_flash=True)
        for layer, (k, v, *mamba) in enumerate(kv):
            for name, new in (("k", k), ("v", v)):
                row = cache[name][layer]
                row.index_put_(at, new[0, S - keep:].to(row.dtype))
            for name, st in (mamba[0].items() if mamba else ()):
                cache["mamba"][name][layer].index_copy_(0, idx, st)
        cache["slot_pos"].index_copy_(0, idx, sp_row[None])
        cache["pos"].index_fill_(0, idx, S)
        return cache, self.lm_logits(params, h[:, -1:, :])

    @torch.no_grad()
    def decode_step(self, params, cache: Dict[str, Any],
                    tokens: torch.Tensor):
        """One decode step for tokens (B, 1) or embeddings (B, 1, D);
        updates ``cache`` IN PLACE
        (k/v/slot_pos, the recurrent states and pos: the same tensors, so
        a captured graph of this step replays on them) -> (cache, logits
        (B, 1, V))."""
        cfg = self.config
        if cfg.family == "ssm":
            return self._xlstm_decode(params, cache, tokens)
        x = self.embed_inputs(params, tokens)
        B = x.shape[0]
        pos = cache["pos"]
        sin, cos = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
        # the new position's slot is the same in every layer's cache
        rows, slot, keep = insert_slots(pos, cache["slot_pos"].shape[1],
                                        ring=self._cache_ring(cache))
        cache_insert(cache["slot_pos"], pos[:, None], rows, slot, keep)
        for layer, bp in enumerate(params["blocks"]):
            h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
            q, k, v = self._qkv(bp, h, sin, cos)
            kc, vc = cache["k"][layer], cache["v"][layer]
            cache_insert(kc, k, rows, slot, keep)
            cache_insert(vc, v, rows, slot, keep)
            attn = decode_attention(q, kc, vc, cache["slot_pos"], pos,
                                    window=cfg.sliding_window)
            mixer = dense_apply(attn.reshape(B, 1, cfg.attn_dim),
                                bp["attn"]["wo"])
            if cfg.family == "hybrid":
                bufs = cache["mamba"]
                m_out, st = ssm_mod.mamba_step(
                    bp["mamba"], h[:, 0, :],
                    {k: t[layer] for k, t in bufs.items()})
                _write_state(bufs, st, (layer,))
                mixer = 0.5 * (mixer + m_out[:, None, :])
            x = self._mlp(bp, x + mixer)
        pos.add_(1)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return cache, self.lm_logits(params, h)

    def _xlstm_decode(self, params, cache: Dict[str, Any],
                      tokens: torch.Tensor):
        """One xLSTM decode step: each block's state read from ``cache``
        and written back IN PLACE."""
        cfg = self.config
        H = cfg.num_heads
        x = self.embed_inputs(params, tokens)[:, 0, :]
        for g, gp in enumerate(params["blocks"]):
            for i in range(gp["mlstm"]["w_up"].shape[0]):
                bp = tree_map(lambda t, i=i: t[i], gp["mlstm"])
                h = rmsnorm(bp["norm"], x[:, None, :], cfg.norm_eps)[:, 0]
                out, st = ssm_mod.mlstm_step(
                    _cell(bp), h, {k: t[g, i] for k, t in
                                   cache["mlstm"].items()}, num_heads=H)
                _write_state(cache["mlstm"], st, (g, i))
                x = x + out
            bp = gp["slstm"]
            h = rmsnorm(bp["norm"], x[:, None, :], cfg.norm_eps)[:, 0]
            out, st = ssm_mod.slstm_step(
                _cell(bp), h, {k: t[g] for k, t in cache["slstm"].items()},
                num_heads=H)
            _write_state(cache["slstm"], st, (g,))
            x = x + out
        cache["pos"].add_(1)
        h = rmsnorm(params["final_norm"], x[:, None, :], cfg.norm_eps)
        return cache, self.lm_logits(params, h)

    @torch.no_grad()
    def decode_many(self, params, cache: Dict[str, Any],
                    tokens: torch.Tensor, num_steps: int,
                    sampler: Optional[Callable] = None,
                    keys: Optional[torch.Tensor] = None,
                    with_flags: bool = False):
        """``num_steps`` decode steps, each sampling the next token on the
        device and feeding it back; no host sync. Returns (cache, tokens
        (B, num_steps)), column 0 being the token after ``tokens``.

        ``keys``: optional per-step keys, leading dim ``num_steps`` (e.g.
        ``sampler.fold_key_grid``); then the sampler is called as
        ``sampler(logits, keys[step])``, so a stochastic sampler draws a
        fresh stream each step.

        ``with_flags``: also return (B, num_steps) bool flags, True where
        that row's logits at that step were all finite. They only observe
        the logits: the tokens are the same with or without them.
        """
        if sampler is None:
            from repro_torch.serve.sampler import greedy_sample
            sampler = greedy_sample
        out, flags = [], []
        tok = tokens
        for step in range(num_steps):
            cache, logits = self.decode_step(params, cache, tok)
            tok = sampler(logits) if keys is None else sampler(logits,
                                                              keys[step])
            out.append(tok)
            if with_flags:
                flags.append(finite_rows(logits))
        if with_flags:
            return cache, torch.cat(out, dim=1), torch.stack(flags, dim=1)
        return cache, torch.cat(out, dim=1)

    # ----------------------------------------------------- chunked verify path

    def _require_kv_family(self, what: str) -> None:
        """Rewinding needs per-position KV rows; a recurrent family would
        need per-step state. MoE keeps KV rows and passes, as in the
        reference."""
        if self.config.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"{what} needs per-position KV rows to rewind; family="
                f"{self.config.family!r} carries recurrent state: serve it "
                "without speculation")

    @torch.no_grad()
    def verify_chunk(self, params, cache: Dict[str, Any],
                     tokens: torch.Tensor):
        """K positions per row in one pass -> (cache, logits (B, K, V)).

        ``tokens`` (B, K) (or embeddings (B, K, D)): the last committed
        token, then K - 1 drafts.
        Row b runs at its own positions ``pos[b] .. pos[b] + K - 1`` (per
        row rope and causal horizon). In a full cache the chunk's k/v are
        inserted FIRST, IN PLACE, then ``chunk_attention`` masks by
        ``slot_pos <= q_pos``, so query i sees keys 0 .. i of the chunk.
        A ring cache attends in two parts: the chunk's k/v beside the
        UNMODIFIED ring (an insert at pos + j evicts pos + j - C, which
        query pos + i < pos + j may still see), then writes them; a chunk
        longer than the ring (K > C) raises ``ValueError``.
        ``pos`` advances by K: a caller that may reject a suffix takes a
        ``cache_snapshot`` before and ``cache_rollback`` after. The GEMMs
        run at M = B * K (packed weights through their kernels, dense ones
        through ``torch.matmul``).
        """
        self._require_kv_family("verify_chunk")
        cfg = self.config
        x = self.embed_inputs(params, tokens)
        B, K = tokens.shape[:2]
        pos = cache["pos"]
        C = cache["slot_pos"].shape[1]
        ring = self._cache_ring(cache)
        if ring and K > C:
            raise ValueError(f"verify chunk of {K} tokens exceeds the ring "
                             f"cache's window capacity {C}: lower draft_k")
        idx, slot, src, write = chunk_slots(pos, K, C, ring)
        sin, cos = rope_tables(idx, cfg.head_dim, cfg.rope_theta)
        # every layer masks against one view: the ring's pre-chunk slots
        # beside the chunk's positions, or the full cache after the insert
        sp_ring = (torch.cat([cache["slot_pos"], idx], dim=1) if ring
                   else None)
        cache_insert_chunk(cache["slot_pos"], idx, slot, src, write)
        for layer, bp in enumerate(params["blocks"]):
            h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
            q, k, v = self._qkv(bp, h, sin, cos)
            kc, vc = cache["k"][layer], cache["v"][layer]
            if ring:
                attn = chunk_attention(
                    q, torch.cat([kc, k.to(kc.dtype)], dim=1),
                    torch.cat([vc, v.to(vc.dtype)], dim=1), sp_ring, idx,
                    window=cfg.sliding_window)
            cache_insert_chunk(kc, k, slot, src, write)
            cache_insert_chunk(vc, v, slot, src, write)
            if not ring:
                attn = chunk_attention(q, kc, vc, cache["slot_pos"], idx,
                                       window=cfg.sliding_window)
            x = x + dense_apply(attn.reshape(B, K, cfg.attn_dim),
                                bp["attn"]["wo"])
            x = self._mlp(bp, x)
        pos.add_(K)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return cache, self.lm_logits(params, h)

    def cache_snapshot(self, cache: Dict[str, Any], K: int
                       ) -> Dict[str, Any]:
        """The cache rows the next K inserted positions overwrite, so
        ``cache_rollback`` can rewind exactly: per layer k/v (B, K, KV,
        hd), their ``slot_pos`` (B, K), ``pos`` and the chunk's slots
        (``chunk_slots``). A ring needs them: a rejected insert that
        wrapped overwrote live window rows. No host sync; every shape is
        fixed by (B, K)."""
        self._require_kv_family("cache_snapshot")
        pos = cache["pos"]
        _, slot, src, write = chunk_slots(pos, K, cache["slot_pos"].shape[1],
                                          self._cache_ring(cache))
        b = torch.arange(pos.shape[0], device=pos.device)[:, None]
        return {"k": [t[b, slot] for t in cache["k"]],
                "v": [t[b, slot] for t in cache["v"]],
                "slot_pos": cache["slot_pos"][b, slot],
                "slot": slot, "src": src, "write": write,
                "pos": pos.clone()}

    def cache_rollback(self, cache: Dict[str, Any], snap: Dict[str, Any],
                       keep: torch.Tensor) -> Dict[str, Any]:
        """Rewind ``cache`` IN PLACE to ``snap``'s position plus ``keep``
        (B,) accepted inserts per row: the rows after them get their k/v
        and ``slot_pos`` back from the snapshot (``torch.where`` on the
        gathered rows, no data-dependent shape) and ``pos`` becomes
        ``snap["pos"] + keep``. The cache is then bit-identical to one
        that never saw the rejected positions."""
        self._require_kv_family("cache_rollback")
        slot = snap["slot"]
        b = torch.arange(slot.shape[0], device=slot.device)[:, None]
        rej = (snap["src"] >= keep[:, None]) & snap["write"]
        for name in ("k", "v"):
            for t, saved in zip(cache[name], snap[name]):
                sel = rej.view(rej.shape + (1,) * (saved.ndim - 2))
                t[b, slot] = torch.where(sel, saved, t[b, slot])
        sp = cache["slot_pos"]
        sp[b, slot] = torch.where(rej, snap["slot_pos"], sp[b, slot])
        cache["pos"].copy_(snap["pos"] + keep.to(snap["pos"].dtype))
        return cache


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(B, ...) logits -> (B,) bool: every value of the row finite."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=1)
