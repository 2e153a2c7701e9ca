"""Architecture config system.

Every assigned architecture (plus the paper's own evaluation models) is
expressed as an ``ArchConfig``: a declarative description of a decoder-only
LM-family backbone built from a sequence of *stages*. Each stage is a
homogeneous stack of blocks executed under ``jax.lax.scan`` (compact HLO,
fast multi-device compiles); heterogeneous archs (zamba2 hybrid, xlstm,
gemma3 local:global) compose multiple block kinds inside one scanned
superblock or via per-layer flag arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Block kinds understood by repro_torch.models.transformer
ATTN_MLP = "attn_mlp"          # attention + dense MLP (pre-norm residual)
ATTN_MOE = "attn_moe"          # attention + MoE FFN
MAMBA2 = "mamba2"              # Mamba2 (SSD) block
ZAMBA_SUPER = "zamba_super"    # 5x mamba2 + 1x (mamba2 + shared attention)
XLSTM_PAIR = "xlstm_pair"      # mLSTM block followed by sLSTM block


@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str
    n_layers: int               # number of scan iterations of this stage
    # gemma3-style local:global interleave: period P means layer i is
    # *global* iff (i % P == P-1); 0 disables windowing entirely.
    local_global_period: int = 0


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    capacity_factor: float = 1.25
    n_shared_experts: int = 0   # one SwiGLU of n_shared * d_expert beside
    # the routed experts, run on every token
    # "softmax": top-k of the router's softmax, weights renormalised;
    # "sigmoid": the router's sigmoid scores (its product in f32), top-k of
    # the scores plus a per-layer expert bias (``moe.expert_bias``,
    # selection only), weights the unbiased scores renormalised
    score_func: str = "softmax"
    route_scale: float = 1.0    # the combine weights' multiplier


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_heads: int = 0            # 0 -> derived: d_inner // head_dim
    head_dim: int = 64
    chunk: int = 256            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    stages: Tuple[Stage, ...] = ()
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0     # window size for local layers (0 = none)
    rope_local_only: bool = False   # global layers of a local:global
    # interleave attend without RoPE (NoPE)
    attn_out_gate: bool = False     # attention output times sigmoid of a
    # projection of the layer's normed input (``attn.wg``), before ``wo``
    sandwich_norm: bool = False     # an RMSNorm on each sublayer's output
    # before its residual add (``post_attn_norm``, ``post_mlp_norm``)
    mlp_gated: bool = True      # SwiGLU (3 mats) vs plain GELU MLP (2 mats)
    # MoE / SSM options
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # embedding / head options
    tie_embeddings: bool = False
    n_codebooks: int = 0        # musicgen-style multi-head output (0 = plain LM)
    embed_inputs: bool = True   # False -> input_specs provides embeddings (stub frontend)
    embed_multiplier: float = 1.0   # the embedding's output scaled (muP)
    # norm
    norm_eps: float = 1e-5
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # kernel backend for the serving hot path: "reference" (pure-JAX
    # twins), "pallas" (flash prefill / paged decode / MoE GMM), or
    # "auto" (pallas on TPU/GPU, interpret-mode pallas for CPU
    # validation, reference otherwise) — see repro_torch.kernels.resolve_backend
    kernels: str = "reference"

    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so embedding/head shards
        divide evenly on the 16-way model axis (MaxText-style padding)."""
        return ((self.vocab + 255) // 256) * 256

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head).  Over the
        published vocabulary, not the padded one the params hold, and
        without QK-norm scales, as the JAX package counts (the dry run's
        model FLOPs are held to its count)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        emb = V * d if self.embed_inputs else 0
        head = 0 if self.tie_embeddings else V * d * max(1, self.n_codebooks or 1)
        total = emb + head
        q = self.n_heads * self.d_head
        kv = self.n_kv_heads * self.d_head
        attn = d * q + 2 * d * kv + q * d  # wq, wk, wv, wo
        if self.qkv_bias:
            attn += q + 2 * kv
        if self.attn_out_gate:
            attn += d * q                  # wg
        norms = (4 if self.sandwich_norm else 2) * d
        mlp = (3 if self.mlp_gated else 2) * d * ff  # SwiGLU vs plain MLP
        for st in self.stages:
            n = st.n_layers
            if st.kind == ATTN_MLP:
                total += n * (attn + mlp + norms)
            elif st.kind == ATTN_MOE:
                m = self.moe
                expert = 3 * d * m.d_expert
                bias = m.n_experts if m.score_func == "sigmoid" else 0
                total += n * (attn + d * m.n_experts + bias  # router
                              + (m.n_experts + m.n_shared_experts) * expert
                              + norms)
            elif st.kind == MAMBA2:
                total += n * self._mamba_params() + n * d
            elif st.kind == ZAMBA_SUPER:
                total += n * (6 * (self._mamba_params() + d))
            elif st.kind == XLSTM_PAIR:
                total += n * self._xlstm_pair_params()
        if any(st.kind == ZAMBA_SUPER for st in self.stages):
            total += attn + mlp + 2 * d  # the shared attention block (counted once)
        total += d  # final norm
        return total

    def _mamba_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_in = s.expand * d
        nh = s.n_heads or d_in // s.head_dim
        # in_proj -> [z, x, B, C, dt], conv, A_log, D, norm, out_proj
        conv_dim = d_in + 2 * s.d_state * 1  # x, B, C share the conv (groups=dim)
        return (d * (2 * d_in + 2 * s.d_state + nh) + conv_dim * s.d_conv
                + 2 * nh + d_in + d_in * d)

    def _xlstm_pair_params(self) -> int:
        d = self.d_model
        h = self.n_heads
        # mLSTM block: up-proj 2x, q/k/v over inner, i/f/o gates, out
        d_in = 2 * d
        m = d * 2 * d_in + 3 * d_in * d_in + 3 * d_in + d_in * d + 2 * d
        # sLSTM block: 4 gates (i,f,z,o) each d->d + post up/down MLP 4/3
        ff = int(d * 4 / 3)
        s = 4 * d * d + 4 * d + 2 * d * ff + 2 * d
        return m + s

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        expert = 3 * self.d_model * m.d_expert
        inactive = (m.n_experts - m.top_k) * expert
        n_moe_layers = sum(st.n_layers for st in self.stages if st.kind == ATTN_MOE)
        return self.param_count() - n_moe_layers * inactive

    def tiny(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        scale = {}
        scale["n_layers"] = min(self.n_layers, 2)
        stages = []
        for st in self.stages:
            stages.append(dataclasses.replace(
                st, n_layers=1,
                local_global_period=min(st.local_global_period, 2)))
            if len(stages) == 2:
                break
        scale["stages"] = tuple(stages)
        scale["d_model"] = 64
        scale["n_heads"] = 4
        scale["n_kv_heads"] = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4
        scale["d_head"] = 16
        scale["d_ff"] = 128
        scale["vocab"] = 256
        if self.moe is not None:
            scale["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert=32)
        if self.ssm is not None:
            scale["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=8)
        if self.sliding_window:
            scale["sliding_window"] = 16
        scale["name"] = self.name + "-tiny"
        return dataclasses.replace(self, **scale)


def simple_stages(kind: str, n_layers: int, period: int = 0) -> Tuple[Stage, ...]:
    return (Stage(kind=kind, n_layers=n_layers, local_global_period=period),)
