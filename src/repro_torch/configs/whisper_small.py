"""whisper-small [audio]: enc-dec; mel/conv frontend STUBBED as frame
embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio", source="arXiv:2212.04356",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51968, is_encoder_decoder=True, n_enc_frames=1500,
    rope=False, learned_pos=True, norm="layernorm", mlp="gelu",
    connection="fal", max_seq=32768,
)
