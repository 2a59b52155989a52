"""Model/config registry for the FAL reproduction framework.

Every assigned architecture gets a module in this package exporting
``CONFIG: ModelConfig``.  ``get_config(arch_id)`` resolves it; reduced smoke
variants come from ``ModelConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

ConnectionMode = str  # 'preln' | 'parallel' | 'fal' | 'falplus'

VALID_CONNECTIONS = ("preln", "parallel", "fal", "falplus",
                     "ablation1", "ablation2")  # ablations: paper Apdx D.1
VALID_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # citation for the config numbers

    # trunk ------------------------------------------------------------------
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 3072
    vocab: int = 50257
    max_seq: int = 8192

    # paper's contribution ----------------------------------------------------
    connection: ConnectionMode = "preln"

    # attention options --------------------------------------------------------
    rope: bool = True
    rope_theta: float = 10000.0
    learned_pos: bool = False           # gpt2/whisper style
    qk_norm: bool = False               # qwen3
    attn_softcap: float = 0.0           # gemma2 (50.0); 0 disables
    final_softcap: float = 0.0          # gemma2 (30.0)
    sliding_window: int = 0             # 0 = full attention
    layer_pattern: str = "uniform"      # uniform | local_global (gemma2)
    post_norms: bool = False            # gemma2 post-attn/post-ffn norms
    embed_scale: bool = False           # gemma2: multiply embeddings by sqrt(d)

    # norms / mlp ---------------------------------------------------------------
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    mlp: str = "swiglu"                 # swiglu | gelu | geglu
    tie_embeddings: bool = True

    # MoE -----------------------------------------------------------------------
    n_experts: int = 0                  # 0 = dense MLP
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                   # per-expert hidden (deepseek: 2048)
    first_dense_layers: int = 0         # deepseek: first 3 layers dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # group-limited routing (DeepSeek-V3 §: node-limited top-k): each token's
    # experts restricted to <= route_group_limit of route_groups expert
    # groups; with groups aligned to expert-parallel shards this bounds the
    # all-to-all duplication to route_group_limit copies instead of top_k
    # (EXPERIMENTS.md §Perf D3).  0 = off.
    route_groups: int = 0
    route_group_limit: int = 4
    dense_d_ff: int = 0                 # d_ff of the dense layers (deepseek 18432)

    # MLA (deepseek) --------------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2) ------------------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (zamba2) -------------------------------------------------------------
    attn_every: int = 0                 # shared attention block every N ssm layers
    shared_attn: bool = False           # weight-shared attention block

    # enc-dec (whisper) -------------------------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    n_enc_frames: int = 1500            # stubbed audio frame embeddings

    # vlm (llava) ----------------------------------------------------------------------
    n_image_tokens: int = 0             # stubbed patch embeddings (anyres tiles)

    # MTP (deepseek) ------------------------------------------------------------
    mtp_depth: int = 0                  # extra multi-token-prediction heads

    # numerics -------------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    attn_block_q: int = 512             # blockwise-attention tile sizes
    attn_block_k: int = 1024
    # beyond-paper sharding (EXPERIMENTS.md §Perf):
    #   'auto'     — GSPMD decides (baseline; with Hkv < model-size it picks
    #                contraction sharding and all-reduces the score matmuls)
    #   'sequence' — context-parallel attention via shard_map: q sharded on
    #                seq over `model`, K/V gathered, zero attention ARs
    attn_shard: str = "auto"

    def __post_init__(self):
        assert self.connection in VALID_CONNECTIONS, self.connection
        assert self.family in VALID_FAMILIES, self.family

    # -------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic / long-context-capable (see DESIGN.md skip matrix)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window and self.layer_pattern == "local_global":
            return True  # gemma2
        if self.use_mla:
            return True  # deepseek MLA compressed KV
        return self.sliding_window > 0

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims (<=512 d_model,
        2 layers, <=4 experts)."""
        kw = dict(
            n_layers=2 if self.family != "hybrid" else 4,
            d_model=min(self.d_model, 128),
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            max_seq=256,
            dtype="float32",
            param_dtype="float32",
            remat=False,
            attn_block_q=32,
            attn_block_k=64,
        )
        if self.n_experts:
            # capacity_factor = E makes C >= T*k (dropless): capacity drops
            # depend on the token count and would make prefill != decode in
            # the equivalence tests.
            kw.update(n_experts=4, top_k=2, moe_d_ff=64, capacity_factor=4.0,
                      route_groups=2 if self.route_groups else 0,
                      route_group_limit=1,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_dense_layers=min(self.first_dense_layers, 1),
                      dense_d_ff=128 if self.dense_d_ff else 0)
        if self.use_mla:
            kw.update(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.is_encoder_decoder:
            kw.update(n_enc_layers=2, n_enc_frames=16)
        if self.n_image_tokens:
            kw.update(n_image_tokens=16)
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.mtp_depth:
            kw.update(mtp_depth=1)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
ARCH_IDS = (
    "zamba2-1.2b",
    "llava-next-mistral-7b",
    "qwen3-4b",
    "mamba2-370m",
    "deepseek-v3-671b",
    "minicpm-2b",
    "qwen3-moe-30b-a3b",
    "whisper-small",
    "gemma2-27b",
    "llama3.2-3b",
    # paper's own model family (reproduction baselines)
    "gpt2-117m",
    "gpt2-774m",
    "gpt2-1.5b",
)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ModelConfig = mod.CONFIG
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """DESIGN.md §Decode-shape skip matrix."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (DESIGN.md skip matrix)")
    if shape.name == "long_500k" and cfg.is_encoder_decoder:
        return False, "enc-dec (whisper): 500k decode out of family scope"
    return True, ""
