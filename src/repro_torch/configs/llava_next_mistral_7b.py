"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, anyres vision tiles
stubbed as precomputed patch embeddings [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b", family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, n_image_tokens=2880,  # 5 anyres tiles x 576 patches
    norm="rmsnorm", mlp="swiglu", connection="fal", tie_embeddings=False,
    max_seq=32768,
)
