"""GPT-2 1.5B (48L): paper Table 1 baseline."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gpt2-1.5b", family="dense", source="paper Table 1",
    n_layers=48, d_model=1600, n_heads=25, n_kv_heads=25, d_ff=6400,
    vocab=50304, rope=False, learned_pos=True, norm="layernorm", mlp="gelu",
    connection="preln", max_seq=1024,
)
