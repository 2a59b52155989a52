"""GPT-2 117M: the paper's motivation-analysis model (Pre-LN, MHA, GELU,
learned positions)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gpt2-117m", family="dense", source="paper baseline (GPT-2)",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=50304, rope=False, learned_pos=True, norm="layernorm", mlp="gelu",
    connection="preln", max_seq=1024,
)
