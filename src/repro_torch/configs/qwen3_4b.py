"""qwen3-4b [dense]: qk_norm + GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b", family="dense", source="hf:Qwen/Qwen3-8B",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
    norm="rmsnorm", mlp="swiglu", connection="fal", max_seq=32768,
)
