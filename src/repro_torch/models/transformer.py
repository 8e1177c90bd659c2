"""Decoder with AB-Sparse attention (counterpart of
``repro.models.transformer``): a stack of per-kind layers, ``layer l`` of
kind ``cfg.layer_pattern[l % len(pattern)]`` (JAX's plan: cycles of the
pattern, then its first ``n_layers % len(pattern)`` kinds).  Each block's
FFN is the MLP, or with ``cfg.moe`` the MoE FFN (:mod:`.moe`) over JAX's
token groups (512 tokens in prefill, the ``B`` slots in decode).  A
MusicGen model adds sinusoidal absolute positions to its embeddings on
top of RoPE, as JAX's does (the test is on the config's name).

Layer kinds and their cache entries (batch on axis 0 in every one):

- ``"attn"``: global attention over the paged KV cache, AB-Sparse when the
  plan is active (below);
- ``"local_attn"``: sliding-window attention (``cfg.local_window``) over a
  ring buffer ``k`` / ``v`` ``[B, n_kv, W, hd]``, ``W = min(window,
  max_context)``: prefill writes the last ``min(W, S)`` rows at slot
  ``position % W``, decode writes its token there and attends the live
  slots (:func:`~repro_torch.models.layers.ring_valid`);
- ``"rglru"``: Griffin's recurrent block (:mod:`.rglru`), state ``h [B,
  lru]`` f32 and ``conv [B, 3, lru]``;
- ``"rwkv"``: RWKV-6 time mixing (:mod:`.rwkv6`), state ``S [B, H, N, N]``
  f32 and ``xprev [B, d]``.

Local attention and both recurrences are plain PyTorch, as JAX computes
them in plain jnp: no Pallas kernel exists for them to port.  Their
states are updated in place, so a decode step is not idempotent on them
(:data:`CARRIED` names them for the graphed step).

Entry points:
  prefill          prompt (after optional prefix embeddings) -> KV cache,
                   ring buffers and recurrent states + decode store (+
                   prefill score segment under sparse prefill)
  prefill_chunk    one prompt chunk of one batch slot (``("attn",)``
                   stacks only: :meth:`Transformer.supports_chunked_prefill`)
  decode_step      one token for every slot: score -> top-K_h -> attend
                   (fused kernel or staged, ``SparseConfig.fused_decode``)
                   on global attention layers, the O(1) updates elsewhere
  forward_train    full causal pass for training, plain PyTorch with
  / loss           gradients from autograd (chunked CE plus the MoE aux
                   loss), as JAX trains through no Pallas kernel

Prefill is query-block sparse when ``SparseConfig.sparse_prefill`` is on
and the plan is active; otherwise (the default) it is dense causal
attention (``AttentionBackend.causal_attention``: the flash kernel, with
the chunk's offset and live length for a chunk).  Decode is sparse when
the plan is active at ``max_context`` (``SparseConfig.enabled``, some
attention layer, ``context >= 2 x budget``), and attends every live token
when it is not (``AttentionBackend.dense_decode``) or on the ``"dense"``
backend (whose ``decode`` runs the same); an inactive plan allocates no
store.  AB-Sparse (``enabled``) needs the ``("attn",)`` stack, as in JAX.

The JAX model scans over stacked layer parameters and donates its cache;
here the layers are a Python loop over per-layer cache tensors, and every
cache tensor (KV pages, stores, states, ``seq_len``) is updated in place.
The global KV cache is always the paged ``[B, n_kv, n_pages, page, hd]``
tensor, viewed as JAX's dense ``[B, n_kv, S, hd]`` where JAX holds that
layout (the bytes are the same).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.backends import AttentionPlan, CentroidStore, build_plan, get_backend
from repro_torch.config import ModelConfig
from repro_torch.core.centroids import rank_query
from repro_torch.core.quantization import store_bits, store_symmetric
from repro_torch.core.selection import selected_page_masks
from repro_torch.distributed import kernel_partition
from repro_torch.models import layers, rglru, rwkv6
from repro_torch.models.layers import DecoderLayer
from repro_torch.models.moe import aux_loss, moe_ffn

Cache = Dict[str, Any]

#: the recurrent states a decode step updates in place from their own
#: values (the ring buffers and KV pages it only overwrites at the step's
#: position)
CARRIED = ("h", "conv", "S", "xprev")
#: query chunk of local attention's prefill
LOCAL_CHUNK = 512
#: random init of the weights JAX sets to constants (``rglru.lam`` is
#: ``linspace(2, 6)``, done apart)
_CONSTANT_INIT = {"mu": 0.5, "u": 0.5, "w_bias": -2.0, "conv_b": 0.0}


#: ``forward_train``'s activation-checkpoint policies
REMAT = ("none", "full", "dots")


class _CastCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def cast_cotangent(x: torch.Tensor, dtype) -> torch.Tensor:
    """Identity forward; the cotangent cast to ``dtype`` on the way back
    (JAX's ``cast_cotangent``, which keeps the backward chain in the model
    dtype; autograd also hands each tensor a gradient of its own dtype)."""
    return _CastCotangent.apply(x, dtype)


def _dots_policy(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    """Remat "dots": keep the outputs of ``aten.mm`` (the projections, the
    router; JAX's "dots with no batch dims"), recompute everything else,
    the attention's batched products included."""
    return create_selective_checkpoint_contexts(_dots_policy)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for,
    unless a ``FakeTensorMode`` is active (the contract verifier's fake
    CUDA tensors, which allocate nothing)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and torch._guards.detect_fake_mode() is None):
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "versions of the kernels on the CPU"
        )
    return dev


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.sparse.enabled and cfg.layer_pattern != ("attn",):
            raise ValueError(
                "AB-Sparse decode assumes a homogeneous global-attention "
                f"stack: layer pattern {cfg.layer_pattern} needs "
                "SparseConfig(enabled=False)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        d = cfg.d_model
        mk = lambda shape: nn.Parameter(
            torch.empty(shape, dtype=self.dtype, device=self.device),
            requires_grad=False,
        )
        self.embed = mk((cfg.vocab_size, d))
        self.final_norm = mk((d,))
        self.lm_head = None if cfg.tie_embeddings else mk((d, cfg.vocab_size))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, self.dtype, self.device, kind)
            for kind in cfg.layer_kinds
        )
        self.backend = get_backend(cfg.sparse.backend)
        #: the serving mesh this view runs on (:meth:`with_mesh`), or None
        self.mesh = None

    def with_mesh(self, mesh) -> "Transformer":
        """This model on a serving mesh (a
        :class:`~repro_torch.distributed.mesh.ServingMesh`): a shallow copy
        (no weight copied) whose caches hold this rank's batch rows and kv
        heads (:meth:`init_cache`) and whose attention runs on them through
        :mod:`repro_torch.distributed.kernel_partition`, the output
        gathered over heads before the out-projection.  Every weight stays
        whole on every rank (JAX's serving rules replicate ``heads``,
        ``mlp`` and ``vocab``): q / k / v come from the whole projection,
        then this rank's heads are taken, since a projection onto fewer
        columns would round differently.  On a mesh of one rank the caches
        and every call are the single-device ones."""
        if mesh is not None and mesh.sharded and self.cfg.layer_pattern != ("attn",):
            raise NotImplementedError(
                "the recurrent families on a mesh: layer pattern "
                f"{self.cfg.layer_pattern} (only the ('attn',) stack is sharded)")
        view = copy.copy(self)
        view.mesh = mesh
        return view

    def with_sparse(self, **overrides) -> "Transformer":
        """This model under another :class:`SparseConfig` (``overrides`` of
        its fields): a shallow copy with its own ``cfg`` and ``backend``
        and the same parameter tensors and submodules (no weight is
        copied).  The serving engine's degradation
        ladder runs its lower rungs through such views; caches are shared
        too, as long as the overrides keep the cache layout (backend,
        fused or staged decode, sparse prefill)."""
        cfg = dataclasses.replace(
            self.cfg, sparse=dataclasses.replace(self.cfg.sparse, **overrides))
        view = copy.copy(self)
        view.cfg, view.backend = cfg, get_backend(cfg.sparse.backend)
        return view

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Random weights from ``generator``: truncated normals (+-2 std) with
        std 0.02 for the embedding, ``d_in ** -0.5`` for projections and 0.1
        for rglru's ``conv_w``, ones for the norms, zeros for the biases,
        and JAX's constants where JAX sets them (rglru's ``lam`` =
        ``linspace(2, 6)``, ``conv_b`` 0; rwkv's ``mu`` and ``u`` 0.5,
        ``w_bias`` -2): the distribution of ``repro``'s init; the random
        numbers differ."""

        def trunc(p, std):
            tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            p.copy_(tmp)

        trunc(self.embed, 0.02)
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            trunc(self.lm_head, self.cfg.d_model ** -0.5)
        for layer in self.layers:
            for name, p in layer.named_parameters():
                if name.startswith("norm") or name == "ln_x":
                    p.fill_(1.0)
                elif name in ("bq", "bk", "bv"):
                    p.zero_()
                elif name in _CONSTANT_INIT:
                    p.fill_(_CONSTANT_INIT[name])
                elif name == "lam":
                    p.copy_(torch.linspace(2.0, 6.0, p.shape[0]))
                elif name == "conv_w":
                    trunc(p, 0.1)
                else:
                    # fan-in: the row count of [d_in, d_out], expert or not
                    trunc(p, p.shape[-2] ** -0.5)
        return self

    # -------------------------------------------------------------- layouts

    def attention_plan(self, context_len: int) -> AttentionPlan:
        return build_plan(self.cfg, context_len)

    def use_sparse(self, context_len: int) -> bool:
        return self.attention_plan(context_len).active

    def prefix_rows(self, prefix_emb) -> int:
        """Rows that prefix embeddings ``[..., P, d]`` take before the
        tokens: ``P`` in a ``"vlm"`` / ``"audio"`` model, 0 in any other
        (which embeds the tokens alone, as JAX's ``embed_inputs`` does)."""
        if prefix_emb is None or self.cfg.family not in ("vlm", "audio"):
            return 0
        return prefix_emb.shape[-2]

    def embed_inputs(self, tokens: torch.Tensor,
                     prefix_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens ``[B, S]`` -> ``[B, P + S, d]``: the prefix embeddings
        ``[B, P, d]`` (cast to the model dtype) before the token embeddings,
        ``P`` by :meth:`prefix_rows`, then MusicGen's positions ``0 .. P +
        S - 1`` (:meth:`add_positions`), as JAX's ``embed_inputs``."""
        # F.embedding, not ``self.embed[tokens]``: on CUDA the indexing's
        # backward sums a repeated token's rows in bf16 (the tied
        # embedding's gradient then misses its f32 copy's by 7% in phase
        # 13 a), ``chip_smoke.py``); the forward is the same gather
        x = F.embedding(tokens, self.embed)
        if self.prefix_rows(prefix_emb):
            pre = torch.as_tensor(prefix_emb, device=self.device).to(x.dtype)
            x = torch.cat([pre, x], dim=1)
        return self.add_positions(x)

    def add_positions(self, x: torch.Tensor,
                      positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Embeddings ``[B, S, d]`` plus MusicGen's sinusoidal absolute
        positions at ``positions`` (``[B or 1, S]``; ``0 .. S - 1`` when
        None), cast to the model dtype; ``x`` itself for any other model."""
        if not self.cfg.name.startswith("musicgen"):
            return x
        if positions is None:
            positions = torch.arange(x.shape[1], device=self.device)[None]
        return x + layers.sinusoidal_embedding(positions, self.cfg.d_model).to(x.dtype)

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        return torch.matmul(h, self._head())

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head

    # ----------------------------------------------------------- train pass

    def _layer_train(self, layer: DecoderLayer, x: torch.Tensor,
                     positions: torch.Tensor, chunk: int, aux: torch.Tensor):
        """One pre-norm block over the whole sequence (JAX's
        ``_layer_train``) -> (output, aux plus this block's MoE aux)."""
        cfg = self.cfg
        h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
        if layer.kind in ("attn", "local_attn"):
            q, k, v = layers.qkv_project(layer, h, cfg, positions)
            window = cfg.local_window if layer.kind == "local_attn" else None
            attn = layers.chunked_causal_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                chunk=chunk, window=window)
            h = layers.out_project(layer, attn.transpose(1, 2))
        elif layer.kind == "rglru":
            h = rglru.rglru_block(layer, h, cfg)[0]
        else:
            h = rwkv6.rwkv_time_mix(layer, h, cfg)[0]
        x = x + h
        h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
        if cfg.moe is None:
            return x + layers.mlp(layer, h, cfg.activation), aux
        routing = {}
        h = moe_ffn(layer, h, cfg, routing=routing)
        return x + h, aux + aux_loss(routing["probs"], routing["experts"],
                                     cfg.moe.n_experts)

    def forward_train(self, tokens, prefix_emb=None,
                      remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
        """Full causal pass for training (JAX's ``forward_train``):
        tokens ``[B, S]`` (after ``prefix_emb`` ``[B, P, d]``) -> (final
        hidden ``[B, P + S, d]``, the MoE aux loss summed over layers, f32).

        Attention, global or local, is :func:`layers.chunked_causal_attention`
        at JAX's chunk (the largest divisor of ``P + S`` up to 512); no
        cache, plan or kernel.  The layers run in cycles of the pattern,
        each entered through :func:`cast_cotangent` and checkpointed by
        ``remat`` ("none", "full", or "dots": keep the outputs of
        ``aten.mm``, the projections, and recompute the rest), then the
        remainder layers as they are, as JAX's scan body and its tail."""
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, not {remat!r}")
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = self.embed_inputs(tokens, prefix_emb)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)[None]
        chunk = layers.attn_chunk(S)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        n = len(self.cfg.layer_pattern)
        n_cycles = self.cfg.n_layers // n

        def cycle(c, x, aux):
            for layer in self.layers[c * n:(c + 1) * n]:
                x, aux = self._layer_train(layer, x, positions, chunk, aux)
            return x, aux

        for c in range(n_cycles):
            x = cast_cotangent(x, self.dtype)
            if remat == "none":
                x, aux = cycle(c, x, aux)
            else:
                x, aux = checkpoint(
                    cycle, c, x, aux, use_reentrant=False,
                    **({} if remat == "full" else {"context_fn": _save_dots}))
        for layer in self.layers[n_cycles * n:]:
            x, aux = self._layer_train(layer, x, positions, chunk, aux)
        return layers.rms_norm(x, self.final_norm, self.cfg.norm_eps), aux

    def loss(self, tokens, prefix_emb=None, remat: str = "none",
             label_chunk: int = 2048) -> torch.Tensor:
        """Next-token cross-entropy over the token region (prefix rows
        excluded), JAX's ``loss``: f32 logits in chunks of ``label_chunk``
        positions (then the remainder), so ``[B, S, vocab]`` never exists
        at once; plus ``router_aux_weight * aux / n_layers`` with an MoE
        FFN."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        h, aux = self.forward_train(tokens, prefix_emb, remat)
        P = h.shape[1] - tokens.shape[1]
        inputs, targets = h[:, P:-1], tokens[:, 1:]
        w = self._head()
        B, Sm1, _ = inputs.shape
        label_chunk = min(label_chunk, Sm1)
        n_chunks = Sm1 // label_chunk
        rem = Sm1 - n_chunks * label_chunk

        def chunk_loss(h_c, t_c):
            logits = torch.matmul(h_c, w).to(torch.float32)
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, t_c[..., None])[..., 0]
            return torch.sum(logz - gold)

        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for c in range(n_chunks):
            sl = slice(c * label_chunk, (c + 1) * label_chunk)
            total = total + chunk_loss(inputs[:, sl], targets[:, sl])
        if rem:
            total = total + chunk_loss(inputs[:, -rem:], targets[:, -rem:])
        ce = total / (B * Sm1)
        if cfg.moe is not None:
            ce = ce + cfg.moe.router_aux_weight * aux / cfg.n_layers
        return ce

    # ----------------------------------------------------------------- cache

    def init_cache(self, batch: int, max_context: int) -> Cache:
        """Per-layer cache entries for ``batch`` sequences of up to
        ``max_context`` tokens, by layer kind (module docstring): for a
        global attention layer the paged KV pool, with the decode store
        when the plan is active and the prefill score segment when sparse
        prefill runs too; a local-attention layer's ring buffer; a
        recurrent layer's zero state.

        An active plan holds ``max_context // page_size`` pages, as JAX's
        paged cache does; an inactive one, whose JAX cache is dense, pads
        the last page (``ceil(max_context / page_size)`` pages, the rows
        past ``max_context`` never written nor attended).

        On a mesh that splits the call (:meth:`with_mesh`) every entry
        holds this rank's rows and kv heads only (``batch / data`` and
        ``n_kv / model``, or the whole axis where it does not divide), the
        layouts are this rank's (its heads' store rows), and
        ``cache["shard"]`` is the
        :class:`~repro_torch.distributed.kernel_partition.Shard`."""
        cfg, sp = self.cfg, self.cfg.sparse
        hd, ps = cfg.resolved_head_dim, sp.page_size
        plan = self.attention_plan(max_context)
        dev = self.device
        n_pages = max_context // ps if plan.active else -(-max_context // ps)
        shard = self._shard(batch)
        n_kv = cfg.n_kv_heads
        if shard is not None:
            batch, n_kv = shard.n_rows, shard.n_heads
        kv_shape = (batch, n_kv, n_pages, ps, hd)
        if plan.active:
            stk = plan.stacked(dev)
            if shard is not None:
                stk = kernel_partition.shard_layout(stk, shard.heads)
            Dp, bits = plan.rank_key_width, store_bits(sp.quant)
            cw = Dp // 2 if bits == 4 else Dp
            cdt = torch.uint8 if bits else torch.float32
            rows = stk.total_rows
        entries = []
        for kind in cfg.layer_kinds:
            if kind != "attn":
                entries.append(state_entry(cfg, kind, batch, max_context, self.dtype, dev))
                continue
            e = {"k": torch.zeros(kv_shape, dtype=self.dtype, device=dev),
                 "v": torch.zeros(kv_shape, dtype=self.dtype, device=dev)}
            if plan.active:
                e["codes"] = torch.zeros((batch, rows, cw), dtype=cdt, device=dev)
                e["scale"] = torch.ones((batch, n_kv, Dp),
                                        dtype=torch.float32, device=dev)
                e["zero"] = torch.zeros((batch, n_kv, Dp),
                                        dtype=torch.float32, device=dev)
            if plan.active and sp.sparse_prefill:
                e["pcodes"] = torch.zeros((batch, rows, cw), dtype=cdt, device=dev)
                e["pscale"] = torch.ones((batch, rows, 1), dtype=torch.float32,
                                         device=dev)
                e["pzero"] = torch.zeros((batch, rows, 1), dtype=torch.float32,
                                         device=dev)
            entries.append(e)
        cache = {
            "seq_len": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": entries,
            "la": ([stk.layer(l) for l in range(cfg.n_layers)] if plan.active
                   else [None] * cfg.n_layers),
            "max_context": max_context,
        }
        if shard is not None:
            cache["shard"] = shard
        return cache

    def _shard(self, batch: int):
        """This rank's slice of a call over ``batch`` sequences on the mesh,
        or None off a mesh and where the mesh splits nothing."""
        if self.mesh is None:
            return None
        shard = kernel_partition.shard_of(self.mesh, self.mesh.coords, batch,
                                          self.cfg.n_kv_heads)
        return None if shard.trivial else shard

    def _gather_heads(self, shard, attn: torch.Tensor) -> torch.Tensor:
        """An attention output over this shard's heads (dim 1) -> over every
        head, gathered over the mesh's model axis, so the out-projection
        sums the whole head axis in the single-device order."""
        if shard is None or not shard.heads_split:
            return attn
        return self.mesh.all_gather_heads(attn, 1)

    @staticmethod
    def _local_heads(shard, g: int, q, k, v):
        """This shard's heads of a projection's q ``[B, S, Hq, hd]`` and k / v
        ``[B, S, n_kv, hd]`` (the whole projection computed first)."""
        if shard is None or not shard.heads_split:
            return q, k, v
        # contiguous, as the whole projection's are (the kernels take no
        # strided head axis)
        return (shard.take_heads(q, 2, g).contiguous(),
                shard.take_heads(k, 2).contiguous(),
                shard.take_heads(v, 2).contiguous())

    def _kv_layer(self, cache: Cache):
        """The first global attention layer's entry (None without one)."""
        return next((e for layer, e in zip(self.layers, cache["layers"])
                     if layer.kind == "attn"), None)

    @staticmethod
    @torch.no_grad()
    def clear_slot(cache: Cache, slot: int) -> Cache:
        """Reset batch slot ``slot``'s rows to :meth:`init_cache`'s values,
        in place: zero K/V, codes, offsets and recurrent states, unit
        scales.  The decode
        store's affine params span every block of the slot, the rows past
        the live length included, so a reused slot would otherwise quantize
        against its previous occupant's rows (or tiered memory's poison)."""
        for e in cache["layers"]:
            for name, t in e.items():
                t[slot].fill_(1.0 if name in ("scale", "pscale") else 0)
        return cache

    def _kv_heads(self, cache: Cache) -> int:
        """kv heads the cache holds (this rank's on a mesh)."""
        shard = cache.get("shard")
        return self.cfg.n_kv_heads if shard is None else shard.n_heads

    @staticmethod
    def _active(cache: Cache) -> bool:
        return cache["la"][0] is not None

    @staticmethod
    def _has_score_segment(cache: Cache) -> bool:
        return any("pcodes" in e for e in cache["layers"])

    def _sparse_prefill(self, cache: Cache) -> bool:
        """Prefill runs query-block sparse when this model's config asks for
        it and the cache holds the score segment (a model with
        ``sparse_prefill`` off runs dense chunks on a cache built with it
        on, and leaves the segment untouched)."""
        return self.cfg.sparse.sparse_prefill and self._has_score_segment(cache)

    def _store(self, e) -> CentroidStore:
        quant = self.cfg.sparse.quant
        return CentroidStore(e["codes"], e["scale"], e["zero"],
                             store_bits(quant), store_symmetric(quant))

    # --------------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, prefix_emb=None,
                max_context: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens ``[B, S]`` (after ``prefix_emb`` ``[B, P, d]``, see
        :meth:`embed_inputs`) -> (last-token logits [B, vocab], cache of
        ``P + S`` rows)."""
        cfg, sp = self.cfg, self.cfg.sparse
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = self.embed_inputs(tokens, prefix_emb)
        B, S = x.shape[:2]
        max_context = S if max_context is None else max_context
        cache = self.init_cache(B, max_context)
        shard = cache.get("shard")
        if shard is not None:
            # this rank's sequences
            x = shard.take_rows(x)
            B = x.shape[0]
        n_kv, g = self._kv_heads(cache), cfg.n_heads // cfg.n_kv_heads
        active, use_sp = self._active(cache), self._sparse_prefill(cache)
        hd = cfg.resolved_head_dim
        kv0 = self._kv_layer(cache)
        S_max = 0 if kv0 is None else kv0["k"].shape[2] * sp.page_size
        positions = torch.arange(S, device=self.device)[None]
        if use_sp:
            n_valid = torch.full((B,), S, dtype=torch.int32, device=self.device)
        for l, (layer, e, la) in enumerate(
                zip(self.layers, cache["layers"], cache["la"])):
            h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
            if layer.kind != "attn":
                x = x + self._mix_prefill(l, layer, h, e, positions)
                h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
                x = x + layers.ffn(layer, h, cfg)
                continue
            q, k, v = self._local_heads(
                shard, g, *layers.qkv_project(layer, h, cfg, positions))
            kd = e["k"].view(B, n_kv, S_max, hd)
            vd = e["v"].view(B, n_kv, S_max, hd)
            kd[:, :, :S] = k.transpose(1, 2)
            vd[:, :, :S] = v.transpose(1, 2)
            if use_sp:
                store, score = self.backend.prefill_stores(e["k"], la, sp)
                for name, t in (("pcodes", score.codes), ("pscale", score.scale),
                                ("pzero", score.zero)):
                    e[name].copy_(t)
            elif active:
                store = self.backend.prefill_store(e["k"], la, sp)
            if active:
                for name, t in (("codes", store.codes), ("scale", store.scale),
                                ("zero", store.zero)):
                    e[name].copy_(t)
            if use_sp:
                attn, _ = self.backend.prefill_attention(
                    q.transpose(1, 2), e["k"], e["v"], score, la, sp,
                    n_valid=n_valid, shard=shard,
                )
            else:
                attn = self.backend.causal_attention(q.transpose(1, 2), kd, vd)
            attn = self._gather_heads(shard, attn)
            x = x + layers.out_project(layer, attn.transpose(1, 2))
            h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
            x = x + layers.ffn(layer, h, cfg)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        cache["seq_len"].fill_(S)
        return self.unembed(x[:, -1]), cache

    def _mix_prefill(self, l: int, layer: DecoderLayer, h: torch.Tensor,
                     e: Dict, positions: torch.Tensor) -> torch.Tensor:
        """Layer ``l``'s :func:`mix_prefill` (one place to observe it)."""
        return mix_prefill(self.cfg, layer, h, e, positions)

    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill (and so the prefix cache's KV reuse) serves the
        homogeneous global-attention stack only, as in JAX: a ring buffer
        or a recurrent state is not a function of reusable KV pages."""
        return self.cfg.layer_pattern == ("attn",)

    def _require_chunkable(self, what: str):
        if not self.supports_chunked_prefill():
            raise ValueError(f"{what} needs the ('attn',) layer pattern, not "
                             f"{self.cfg.layer_pattern}: prefill in one shot")

    @torch.no_grad()
    def prefill_chunk(self, cache: Cache, slot: int, tokens, offset: int,
                      n_valid: int) -> Tuple[torch.Tensor, Cache]:
        """Process one prompt chunk of batch slot ``slot`` in place.

        ``tokens`` is the chunk buffer (its length sizes the score-refresh
        window, as the JAX model's compiled chunk shape does); only its first
        ``n_valid`` tokens are processed and written at rows
        ``[offset, offset + n_valid)``.  Dense (the default): each chunk
        query attends the slot's keys up to its own position.  Under sparse
        prefill (the cache holds the score segment), ``offset`` must be a
        multiple of ``SparseConfig.prefill_block_q``; the slot's running
        score segment is refreshed with the blocks the chunk completes,
        then each query block attends its forced + top-scored blocks.  The
        decode store is not maintained: call :meth:`refresh_slot_store`
        after the last chunk.  A MusicGen chunk adds its positions at
        ``offset``, so chunked equals single-shot prefill (JAX's chunk adds
        none: the port diverges on purpose).  When the cache carries ``"_ptel"``
        (``[n_layers]`` int32), each sparse layer's entry is set to the
        number of (query block, key block) pairs it attended.
        -> (logits [vocab] at the last valid position, cache)."""
        self._require_chunkable("prefill_chunk")
        cfg, sp = self.cfg, self.cfg.sparse
        C = len(tokens)
        tok = torch.as_tensor(tokens, device=self.device).long()[:n_valid]
        n_kv, hd, ps = self._kv_heads(cache), cfg.resolved_head_dim, sp.page_size
        shard = cache.get("shard")
        if shard is not None:
            # a chunk is a call over one sequence (its rows are not split)
            shard = shard.one_row()
        g = cfg.n_heads // cfg.n_kv_heads
        S_max = cache["layers"][0]["k"].shape[2] * ps
        use_sp = self._sparse_prefill(cache)
        if (use_sp and offset % sp.prefill_block_q) or offset + n_valid > S_max:
            raise ValueError(f"chunk [{offset}, {offset + n_valid}) is not "
                             f"query-block aligned or exceeds {S_max}")
        bits, sym = store_bits(sp.quant), store_symmetric(sp.quant)
        bmax = sp.max_block_size
        window = min(-(-(C + 2 * bmax) // bmax) * bmax, S_max)
        positions = (offset + torch.arange(n_valid, device=self.device))[None]
        x = self.add_positions(self.embed[tok][None], positions)   # [1, n, d]
        ptel = cache.get("_ptel")
        for l, (layer, e, la) in enumerate(
                zip(self.layers, cache["layers"], cache["la"])):
            h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
            q, k, v = self._local_heads(
                shard, g, *layers.qkv_project(layer, h, cfg, positions))
            kslot, vslot = e["k"][slot], e["v"][slot]       # [n_kv, nP, ps, hd]
            kd, vd = kslot.view(n_kv, S_max, hd), vslot.view(n_kv, S_max, hd)
            kd[:, offset:offset + n_valid] = k[0].transpose(0, 1)
            vd[:, offset:offset + n_valid] = v[0].transpose(0, 1)
            if use_sp:
                sstore = CentroidStore(e["pcodes"][slot][None],
                                       e["pscale"][slot][None],
                                       e["pzero"][slot][None], bits, sym)
                self.backend.refresh_score_rows(
                    sstore, kslot[None], la, offset, offset + n_valid, sp, window
                )
                attn, n_att = self.backend.prefill_attention(
                    q.transpose(1, 2), kslot[None], vslot[None], sstore, la, sp,
                    n_valid=offset + n_valid, chunk_offset=offset, shard=shard,
                )
                if ptel is not None and n_att is not None:
                    ptel[l] = n_att.sum()
            else:
                attn = self.backend.causal_attention(
                    q.transpose(1, 2), kd[None], vd[None], offset,
                    offset + n_valid)
            attn = self._gather_heads(shard, attn)
            x = x + layers.out_project(layer, attn.transpose(1, 2))
            h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
            # an MoE groups and sizes its queues by the buffer's C tokens,
            # as JAX's call does (its padding rows come last)
            x = x + layers.ffn(layer, h, cfg, n_tokens=C)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.unembed(x[0, n_valid - 1]), cache

    @torch.no_grad()
    def refresh_slot_store(self, cache: Cache, slot: int) -> Cache:
        """Rebuild one slot's decode-store rows from its K cache, in place
        (same builder as :meth:`prefill`, so the bytes are identical); no-op
        when the plan is inactive (no store)."""
        self._require_chunkable("refresh_slot_store")
        if not self._active(cache):
            return cache
        for e, la in zip(cache["layers"], cache["la"]):
            st = self.backend.prefill_store(e["k"][slot][None], la,
                                            self.cfg.sparse)
            e["codes"][slot] = st.codes[0]
            e["scale"][slot] = st.scale[0]
            e["zero"][slot] = st.zero[0]
        return cache

    @torch.no_grad()
    def refresh_slot_score_rows(self, cache: Cache, slot: int) -> Cache:
        """Rebuild one slot's prefill score segment from its K cache, in
        place (after a prefix-cache install, whose KV never ran a chunk);
        no-op without sparse prefill (no score segment)."""
        self._require_chunkable("refresh_slot_score_rows")
        if not self._has_score_segment(cache):
            return cache
        for e, la in zip(cache["layers"], cache["la"]):
            st = self.backend.prefill_score_rows(e["k"][slot][None], la,
                                                 self.cfg.sparse)
            e["pcodes"][slot] = st.codes[0]
            e["pscale"][slot] = st.scale[0]
            e["pzero"][slot] = st.zero[0]
        return cache

    # ------------------------------------------------------------ decode step

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens) -> Tuple[torch.Tensor, Cache]:
        """One token for every slot at position ``cache["seq_len"]``.
        -> (logits [B, vocab], cache); ``seq_len`` is advanced in place.
        When the cache carries ``"_telemetry"`` (``[n_layers, B, 4]``
        int32), each sparse layer's slice is set to the decode's sparsity
        counters (:func:`~repro_torch.core.selection.selection_telemetry`);
        dense decode (inactive plan, ``"dense"`` backend) sets nothing.
        When it carries ``"_sel_pages"`` and ``"_pre_pages"`` (``[B,
        n_pages]`` bool, planted by tiered KV memory) and the plan is
        active, every layer re-runs the estimation on its store after the
        append and the two are set to the selected and margin-predicted
        pages of the step, OR-ed over heads and layers (on the ``"dense"``
        backend too, as in JAX).  An inactive plan decodes through
        ``AttentionBackend.dense_decode``, an active one through the
        backend's ``append`` and ``decode``.  Local-attention and recurrent
        layers update their entries in place (:func:`mix_decode`), with
        every position from the device ``seq_len`` (no host read, so the
        step can be captured)."""
        cfg, sp = self.cfg, self.cfg.sparse
        tok = torch.as_tensor(tokens, device=self.device).long()
        B = tok.shape[0]
        seq_len = cache["seq_len"]
        positions = seq_len[:, None].long()
        ps = sp.page_size
        bidx = torch.arange(B, device=self.device)
        dense, table = not self._active(cache), None
        shard = cache.get("shard")
        g = cfg.n_heads // cfg.n_kv_heads
        kv0 = self._kv_layer(cache)
        if kv0 is not None:
            k0 = kv0["k"]
            # the rows JAX holds: max_context // ps pages when paged,
            # max_context when dense (an inactive plan's padded page rows are
            # never used)
            S_lim = min(cache["max_context"], k0.shape[2] * ps)
            # JAX drops a write at position S_lim; keep the old row there
            in_range = (seq_len < S_lim)[:, None, None]
            pos = torch.clamp(seq_len.long(), max=S_lim - 1)
            page, within = pos // ps, pos % ps
            # every layer of a step that attends every live token (inactive
            # plan, or the "dense" backend) reads one identity page table
            if dense or self.backend.full_attention:
                live = torch.clamp(seq_len + 1, max=S_lim)
                table = self.backend.full_page_table(k0, live)
        x = self.add_positions(self.embed[tok][:, None], positions)  # [B, 1, d]
        tel = cache.get("_telemetry")
        # tiered KV memory plants "_sel_pages" / "_pre_pages" [B, n_pages]:
        # every sparse layer then reports its selected and margin-predicted
        # pages, OR-ed over layers
        masks = [None, None] if not dense and "_sel_pages" in cache else None
        for l, (layer, e, la) in enumerate(
                zip(self.layers, cache["layers"], cache["la"])):
            h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
            if layer.kind != "attn":
                x = x + mix_decode(cfg, layer, h, e, positions)
                h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
                x = x + layers.ffn(layer, h, cfg, group_size=B)
                continue
            q, k_new, v_new = self._local_heads(
                shard, g, *layers.qkv_project(layer, h, cfg, positions))
            for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0])):
                old = e[name][bidx, :, page, within]         # [B, n_kv, hd]
                e[name][bidx, :, page, within] = torch.where(in_range, new, old)
            if dense:
                out = self.backend.dense_decode(q[:, 0], e["k"], e["v"], live,
                                                ps, table, shard=shard)
            else:
                store = self._store(e)
                self.backend.append(store, e["k"], la, seq_len, sp)
                res = self.backend.decode(
                    q[:, 0], e["k"], e["v"], store, la, sp, seq_len + 1,
                    collect_tel=tel is not None, page_table=table, shard=shard,
                )
                out = res[0]
                if tel is not None and res[3] is not None:
                    tel[l] = res[3]
                if masks is not None:
                    for i, m in enumerate(self._page_masks(q[:, 0], e, la,
                                                           seq_len + 1)):
                        masks[i] = m if masks[i] is None else masks[i] | m
            out = self._gather_heads(shard, out)
            x = x + layers.out_project(layer, out[:, None])
            h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
            x = x + layers.ffn(layer, h, cfg, group_size=B)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        if masks is not None:
            cache["_sel_pages"].copy_(masks[0])
            cache["_pre_pages"].copy_(masks[1])
        seq_len += 1
        return self.unembed(x[:, 0]), cache

    def _page_masks(self, q, e, la, live):
        """(selected, predicted) page masks ``[B, n_pages]`` of one sparse
        layer's decode: the estimation re-run on the store after the append
        (the scores the decode just selected from), then
        :func:`~repro_torch.core.selection.selected_page_masks`."""
        sp = self.cfg.sparse
        rq = rank_query(q, sp.centroid_method, q.shape[-1])
        est = self.backend.scores(rq, self._store(e), la, e["k"].shape[1])
        return selected_page_masks(
            est, la, live, sp.sink_pages, sp.local_pages,
            sp.prefetch_margin_blocks, sp.max_block_size // sp.page_size)



def state_entry(cfg: ModelConfig, kind: str, batch: int, max_context: int, dtype,
                device) -> Dict:
    """A local-attention or recurrent layer's zero cache entry (module
    docstring)."""
    if kind == "local_attn":
        W = min(cfg.local_window, max_context)
        shape = (batch, cfg.n_kv_heads, W, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "rglru":
        h, conv = rglru.init_state(cfg, batch, dtype, device)
        return {"h": h, "conv": conv}
    S, xprev = rwkv6.init_state(cfg, batch, dtype, device)
    return {"S": S, "xprev": xprev}


def mix_prefill(cfg: ModelConfig, layer: DecoderLayer, h: torch.Tensor, e: Dict,
                positions: torch.Tensor) -> torch.Tensor:
    """A local-attention or recurrent layer's token mixing over a whole
    prompt ``h [B, S, d]`` (after its first norm): its output, with the
    layer's cache entry ``e`` filled in place (the ring buffer's last
    ``min(W, S)`` rows at slot ``position % W``, or the recurrence's final
    state)."""
    if layer.kind == "local_attn":
        S = h.shape[1]
        q, k, v = layers.qkv_project(layer, h, cfg, positions)
        k, v = k.transpose(1, 2), v.transpose(1, 2)          # [B, n_kv, S, hd]
        # chunks of 512 queries (JAX takes the largest divisor of S up to
        # 512, which is 1 for a prime S): the last one padded
        attn = layers.chunked_causal_attention(
            q.transpose(1, 2), k, v, chunk=min(LOCAL_CHUNK, S),
            window=cfg.local_window)
        W = e["k"].shape[2]
        L = min(W, S)
        slots = torch.arange(S - L, S, device=h.device) % W
        e["k"][:, :, slots] = k[:, :, S - L:]
        e["v"][:, :, slots] = v[:, :, S - L:]
        return layers.out_project(layer, attn.transpose(1, 2))
    if layer.kind == "rglru":
        out, (h_last, tail) = rglru.rglru_block(layer, h, cfg)
        e["h"].copy_(h_last)
        e["conv"].copy_(tail)
        return out
    out, (S_last, xprev) = rwkv6.rwkv_time_mix(layer, h, cfg)
    e["S"].copy_(S_last)
    e["xprev"].copy_(xprev)
    return out


def mix_decode(cfg: ModelConfig, layer: DecoderLayer, h: torch.Tensor, e: Dict,
               positions: torch.Tensor) -> torch.Tensor:
    """One token's mixing ``h [B, 1, d]`` at ``positions [B, 1]`` for a
    local-attention layer (write the ring slot ``position % W``, attend
    the live slots) or a recurrent one (its state updated in place)."""
    if layer.kind == "local_attn":
        q, k_new, v_new = layers.qkv_project(layer, h, cfg, positions)
        W = e["k"].shape[2]
        slot = positions[:, 0] % W
        bidx = torch.arange(h.shape[0], device=h.device)
        e["k"][bidx, :, slot] = k_new[:, 0]
        e["v"][bidx, :, slot] = v_new[:, 0]
        valid = layers.ring_valid(positions[:, 0], W)
        out = layers.masked_dense_decode(q[:, 0], e["k"], e["v"], valid)
        return layers.out_project(layer, out[:, None])
    if layer.kind == "rglru":
        out, (h_new, tail) = rglru.rglru_decode(layer, h, (e["h"], e["conv"]), cfg)
        e["h"].copy_(h_new)
        e["conv"].copy_(tail)
        return out
    out, (S_new, xprev) = rwkv6.rwkv_decode(layer, h, (e["S"], e["xprev"]), cfg)
    e["S"].copy_(S_new)
    e["xprev"].copy_(xprev)
    return out
