"""mamba2-370m [ssm]: SSD, attention-free [arXiv:2405.21060].
FAL is inapplicable (no MHA-MLP pair) — DESIGN.md §Arch-applicability."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm", source="arXiv:2405.21060",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50304, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256, norm="rmsnorm", connection="preln", rope=False,
    max_seq=524288,
)
