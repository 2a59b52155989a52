"""GPT-2 774M (36L): paper Table 1 baseline."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gpt2-774m", family="dense", source="paper Table 1",
    n_layers=36, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=50304, rope=False, learned_pos=True, norm="layernorm", mlp="gelu",
    connection="preln", max_seq=1024,
)
