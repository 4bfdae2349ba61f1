"""Unified model configuration covering all 10 assigned architectures.

A copy, field for field and with the same defaults, of the reference's
``repro/models/config.py`` (the port imports nothing of ``repro``), so
that the config files under ``repro_torch/configs/`` are the reference's
verbatim.  The sharding, remat and scan fields are kept for that reason;
they have no effect in the port."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False                   # qwen3-style per-head RMSNorm
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_tok: int = 2
    capacity_factor: float = 1.25
    moe_group: int = 512
    # sliding-window attention (None = full causal); mixtral: 4096
    window: Optional[int] = None
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500                     # stub frame-embedding count
    # vlm stub
    n_vis_tokens: int = 0
    # numerics / implementation knobs
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"              # naive | chunked | pallas
    attn_chunk: int = 512
    remat: str = "full"                     # none | dots | full
    scan_layers: bool = True
    # parallelism hints
    shard_experts: bool = False             # EP over a dedicated mesh axis
    # activation data-parallel axes: when set (by the launcher, from the
    # mesh), block inputs/outputs get with_sharding_constraint on batch —
    # without this GSPMD can drop batch sharding after the vocab-sharded
    # embedding gather and run the whole net batch-replicated.
    dp_axes: tuple = ()
    tp_axis: str = "model"
    tp_size: int = 0   # model-axis size (set by the launcher with dp_axes)
    gather_weights: bool = True  # False: keep weights 2D-sharded (decode)
    norm_f32: bool = True        # False: RMSNorm in bf16 (keeps TP AR bf16)
    attn_f32: bool = True        # False: online-softmax state in bf16
    # True: checkpoint each kv-chunk step of the online-softmax scan so its
    # backward RECOMPUTES the probability block instead of saving all
    # (T x S) f32 probabilities — the flash-attention backward structure.
    attn_remat_chunk: bool = False
    # Megatron-style sequence parallelism: activations between blocks are
    # sharded over (tp_axis) on the SEQUENCE dim, turning the TP all-reduce
    # into reduce-scatter + all-gather (half the bytes) and sharding norms.
    seq_shard: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.kind == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the long_500k shape? (SSM/hybrid/SWA)"""
        return self.kind in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> float:
        """Approximate parameter count (for 6ND model-FLOPs accounting)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * ff
        if self.kind == "moe":
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts  # + router
        ssm = 0
        if self.kind in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            n, h = self.ssm_state, self.ssm_heads
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            ssm = d * (2 * d_in + 2 * n * 1 + h) + d_in * d + \
                self.ssm_conv * (d_in + 2 * n) + 2 * h
        per_layer = mlp + (attn if self.kind not in ("ssm",) else 0)
        if self.kind == "ssm":
            per_layer = ssm
        if self.kind == "hybrid":
            n_attn = self.n_layers // max(self.hybrid_attn_every, 1)
            total = self.n_layers * (ssm + d * 2) + 1 * (attn + 3 * d * ff)
            # shared attention block counted once (it is shared)
            return total + V * d * (1 if self.tie_embeddings else 2)
        n_lay = self.n_layers + self.n_enc_layers
        total = n_lay * (per_layer + 2 * d)
        if self.n_enc_layers:  # cross attention in decoder
            total += self.n_layers * attn
        total += V * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> float:
        """Active (per-token) params — differs for MoE (6*N_active*D)."""
        if self.kind != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_mlp = self.experts_per_tok * 3 * d * ff
        full = self.param_count()
        return full - self.n_layers * (self.n_experts - self.experts_per_tok) \
            * 3 * d * ff
