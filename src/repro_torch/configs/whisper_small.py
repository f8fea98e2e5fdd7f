"""Whisper-small [audio] — arXiv:2212.04356.

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865 — encoder-decoder; the
mel-spectrogram + conv frontend is a stub: ``input_specs`` hands the encoder
precomputed frame embeddings (1500 frames after the conv stride-2).
Decode shapes: decode_32k is lowered mechanically against the requested KV
length; long_500k is SKIPPED (448-token native decoder context; see
DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,            # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    use_rmsnorm=False,        # whisper uses LayerNorm + GELU
    is_encoder_decoder=True,
    encoder_layers=12,
    encoder_seq_len=1500,
    max_decoder_len=448,
    embedding_inputs=True,    # frontend stub: frame embeddings precomputed
    citation="arXiv:2212.04356",
)

REDUCED = reduce_config(CONFIG)
