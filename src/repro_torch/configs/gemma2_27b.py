"""gemma2-27b [dense]: local/global alternating attention + logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b", family="dense", source="arXiv:2408.00118",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000, sliding_window=4096,
    layer_pattern="local_global", attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, embed_scale=True, norm="rmsnorm", mlp="geglu",
    connection="fal", max_seq=524288,
)
