"""llama3.2-3b [dense]: small llama3 [hf:meta-llama/Llama-3.2 family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3.2-3b", family="dense", source="hf:meta-llama/Llama-3.2-1B",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, rope_theta=5e5, norm="rmsnorm", mlp="swiglu",
    connection="fal", max_seq=32768,
)
