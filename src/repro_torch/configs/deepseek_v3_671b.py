"""deepseek-v3-671b [moe]: MLA + 1 shared + 256 routed top-8 + MTP
[arXiv:2412.19437]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280, n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3, dense_d_ff=18432, mtp_depth=1,
    # node-limited routing (DeepSeek-V3 §3.4): groups aligned to the 16-way
    # expert-parallel shards, each token restricted to 4 groups — bounds the
    # dispatch all-to-all to 4 shard copies (EXPERIMENTS.md §Perf D3)
    route_groups=16, route_group_limit=4,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    norm="rmsnorm", mlp="swiglu", connection="fal", tie_embeddings=False,
    max_seq=524288,
)
