"""Configuration schema of the PyTorch port (counterpart of ``repro.config``).

What the port's serving and training paths read: the AB-Sparse knobs
(:class:`SparseConfig`), the architecture (:class:`ModelConfig`, with
:class:`MoEConfig` for a mixture-of-experts FFN), the
serving engine's knobs (:class:`ServeConfig`, tiered KV memory included)
and its failure-domain policy (:class:`ResilienceConfig`), the trainer's
knobs (:class:`TrainConfig`) and its execution plan (:class:`MeshPlan`).  Field names and defaults
match the JAX package so one set of values configures both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

CANDIDATE_BLOCK_SIZES: Tuple[int, ...] = (16, 32, 64)
PAGE_SIZE: int = 16  # finest granularity == B_min; physical page size.


@dataclass(frozen=True)
class SparseConfig:
    """AB-Sparse configuration (paper §3)."""

    #: False turns AB-Sparse off: the plan is inactive at every context
    #: (dense decode, no store), as for a model whose layers hold no
    #: growing KV cache (recurrentgemma's local attention, rwkv6).
    enabled: bool = True
    #: attention backend: "reference" (plain PyTorch) | "cuda" (hand-written
    #: Hopper kernels; their plain versions on CPU tensors).
    backend: str = "reference"
    #: decode on the "cuda" backend: True runs the single-launch fused
    #: score -> select -> attend kernel; False the staged path (scoring
    #: kernel, stable-sort top-K_h, paged-attention kernel).  The
    #: "reference" backend always decodes staged.
    fused_decode: bool = False
    #: query-block sparse prefill (the port's prefill requires it on).
    sparse_prefill: bool = False
    prefill_topk_scale: float = 1.0
    prefill_block_q: int = 64
    page_size: int = PAGE_SIZE
    candidate_block_sizes: Tuple[int, ...] = CANDIDATE_BLOCK_SIZES
    #: token budget T shared by all heads.
    token_budget: int = 4096
    #: "mean" | "quest" | "arkvale"
    centroid_method: str = "quest"
    #: "none" | "int8_asym" | "int8_sym" | "int4_asym" | "int4_sym"
    quant: str = "int4_asym"
    #: recall-retention threshold tau of Eq. (2), read by
    #: :func:`repro_torch.core.calibration.calibrate_for_config`.
    tau: float = 0.98
    #: initial (sink) and trailing (local) pages always kept.
    sink_pages: int = 1
    local_pages: int = 4
    #: per-(layer, kv head) block sizes; None -> uniform_block_size.
    block_sizes: Optional[Tuple[Tuple[int, ...], ...]] = None
    uniform_block_size: int = 32
    #: tiered KV memory (:mod:`repro_torch.memory`) prefetch predictor
    #: width: blocks ranked within this margin below each head's top-K
    #: cutoff are emitted as the next step's predicted selection and staged
    #: host -> device.  Fixed for a captured decode step.
    prefetch_margin_blocks: int = 2

    def layer_block_sizes(self, layer: int, n_kv_heads: int) -> Tuple[int, ...]:
        if self.block_sizes is None:
            return (self.uniform_block_size,) * n_kv_heads
        row = self.block_sizes[layer]
        assert len(row) == n_kv_heads
        return tuple(row)

    @property
    def max_block_size(self) -> int:
        sizes = set(self.candidate_block_sizes) | {self.uniform_block_size}
        if self.block_sizes is not None:
            for row in self.block_sizes:
                sizes |= set(row)
        return max(sizes)

    def budget_for(self, context_len: int) -> int:
        b = min(self.token_budget, context_len)
        return (b // self.page_size) * self.page_size


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    #: load-balancing aux loss weight (training only)
    router_aux_weight: float = 0.01
    #: expert capacity ``int(cf * group tokens * K / E)``; >= E / K is
    #: lossless
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    """Decoder architecture (``activation`` is "swiglu", "geglu", "relu2"
    or "gelu", as JAX's ``mlp`` computes them).  ``family`` is "dense",
    "moe" (``moe`` set: every layer's FFN is
    :func:`repro_torch.models.moe.moe_ffn`), "vlm" (``frontend``
    "vision_patches"), "audio" (``frontend`` "audio_frames"; in these two
    a request may carry rows of embeddings that precede its tokens),
    "hybrid" or "ssm".  ``layer_pattern`` is cycled over the layers:
    "attn" (global attention, AB-Sparse when enabled), "local_attn"
    (sliding window of ``local_window`` tokens), "rglru" (Griffin's
    recurrent block) or "rwkv" (RWKV-6 time mixing, heads of
    ``rwkv_head_dim``)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    family: str = "dense"
    moe: Optional[MoEConfig] = None
    layer_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048
    rwkv_head_dim: int = 64
    #: modality front-end stub: None | "vision_patches" | "audio_frames"
    frontend: Optional[str] = None
    n_prefix_embeddings: int = 0
    sparse: SparseConfig = field(default_factory=SparseConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.n_layers))

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        """Indices of the attention layers (global or local), as in JAX."""
        return tuple(i for i, k in enumerate(self.layer_kinds)
                     if k in ("attn", "local_attn"))

    @property
    def is_attention_free(self) -> bool:
        return len(self.attn_layers) == 0


@dataclass(frozen=True)
class MeshPlan:
    """Execution plan of a training step: the trainer reads ``remat``,
    ``grad_accum`` and ``grad_compression``; the mesh fields are JAX's,
    kept as data (the port trains on one device)."""

    multi_pod: bool = False
    #: activation-checkpoint policy per cycle of the layer pattern:
    #: "none" | "full" | "dots" (keep the projections' outputs)
    remat: str = "dots"
    #: microbatches for gradient accumulation (1 = none)
    grad_accum: int = 1
    #: int8 error-feedback gradient compression: allocates the optimizer's
    #: ``error`` residual, as in JAX (whose update does not read it)
    grad_compression: bool = False
    #: shard KV pages over the data axis when decode batch < data-axis size
    context_parallel_decode: bool = True


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    #: relative to the working directory (JAX's default is
    #: ``/tmp/repro_ckpt``); None: the trainer neither saves nor resumes
    checkpoint_dir: Optional[str] = "repro_torch_ckpt"
    keep_checkpoints: int = 3
    #: straggler watchdog: steps whose wall time exceeds
    #: ``straggler_factor`` x the running median are logged.
    straggler_factor: float = 3.0


@dataclass(frozen=True)
class ResilienceConfig:
    """Failure-domain policy of the serving engine (:mod:`repro_torch.resilience`).

    Step faults (injected device errors, non-finite logits) re-run down the
    degradation ladder; faults at the ladder's floor restore the implicated
    sequences from their last checkpoint under a per-request retry budget;
    a tick watchdog turns silent no-progress into a forced preemption.
    """

    #: step faults tolerated per request before it retires as FAILED.
    failure_budget: int = 3
    #: base re-admission backoff in ticks after a checkpoint restore;
    #: doubles with each accumulated failure.
    retry_backoff_ticks: int = 2
    #: committed decode tokens between per-sequence checkpoints (the
    #: checkpoint on entering decode is always taken).
    checkpoint_interval: int = 16
    #: consecutive no-progress ticks (with work pending) before the
    #: watchdog preempts the scheduler's victim.
    watchdog_ticks: int = 8
    #: clean decode ticks at a degraded rung before re-promoting one rung
    #: back toward the configured backend.
    repromote_after: int = 8


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 128
    max_context: int = 524288
    page_size: int = PAGE_SIZE
    temperature: float = 0.6
    top_k: int = 20
    top_p: float = 0.95
    pool_pages: Optional[int] = None
    # -- tiered KV memory (:mod:`repro_torch.memory`) ------------------------
    #: device-resident KV page budget.  ``None`` -> single-tier pool
    #: (``pool_pages`` semantics, everything on the device).  When set, full
    #: KV pages migrate between this budget and a ``host_pages`` spill tier
    #: (LRU by last-selected decode step); the quantized centroid store and
    #: the page tables stay on the device.  Mutually exclusive with
    #: ``pool_pages``; requires the sparse decode path to be active at
    #: ``max_context`` (dense decode reads every row).
    hbm_pages: Optional[int] = None
    #: host (pinned memory) spill-tier capacity in pages; admission control
    #: sees ``hbm_pages + host_pages`` total capacity.
    host_pages: int = 0
    prefill_tokens_per_tick: int = 8192
    prefill_chunk: int = 256
    enable_prefix_cache: bool = True
    interactive_ttft_slo: float = 1.0
    batch_ttft_slo: float = 60.0
    prefix_wait_ticks: int = 8
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)

    def slo_target(self, slo_class: str) -> float:
        if slo_class == "interactive":
            return self.interactive_ttft_slo
        if slo_class == "batch":
            return self.batch_ttft_slo
        raise ValueError(f"unknown SLO class {slo_class!r}")
