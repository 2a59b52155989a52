"""zamba2-1.2b [hybrid]: Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid", source="arXiv:2411.15242",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6, shared_attn=True, norm="rmsnorm", mlp="swiglu",
    connection="fal", max_seq=524288,
)
