"""minicpm-2b [dense]: llama-like, trained with WSD schedule
[arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b", family="dense", source="arXiv:2404.06395",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122880, norm="rmsnorm", mlp="swiglu", connection="fal",
    max_seq=32768,
)
