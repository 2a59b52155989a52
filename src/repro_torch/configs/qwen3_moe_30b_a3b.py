"""qwen3-moe-30b-a3b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe", source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, n_experts=128, top_k=8, moe_d_ff=768,
    qk_norm=True, rope_theta=1e6, norm="rmsnorm", mlp="swiglu",
    connection="fal", max_seq=32768,
)
