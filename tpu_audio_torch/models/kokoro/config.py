"""Kokoro model dimensions (port of tpu_audio/models/kokoro/config.py:
AlbertConfig, KokoroConfig).

Hidden 768, 12 shared ALBERT layers over a 128-wide embedding; the text
encoder 512 × 3 × k5 over 178 symbols; the predictor at d_model 512 with a
128-wide style; the decoder's upsampling [10, 6] into an iSTFT of n_fft 20,
hop 5 at 24 kHz.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class AlbertConfig:
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    hidden_size: int = 768
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    embedding_size: int = 128
    type_vocab_size: int = 2
    vocab_size: int = 178
    layer_norm_eps: float = 1e-12
    dropout: float = 0.0


@dataclass(frozen=True)
class KokoroConfig:
    albert: AlbertConfig = field(default_factory=AlbertConfig)
    d_model: int = 512
    style_dim: int = 128
    n_symbols: int = 178
    max_dur: int = 50  # duration_proj output bins (sigmoid-summed)
    text_encoder_kernel: int = 5
    text_encoder_depth: int = 3
    decoder_hidden: int = 1024
    resblock_kernels: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: tuple = (10, 6)
    upsample_kernels: tuple = (20, 12)
    upsample_initial_channel: int = 512
    istft_n_fft: int = 20
    istft_hop: int = 5
    sample_rate: int = 24000
    harmonic_num: int = 8
    voiced_threshold: float = 10.0
    max_tokens: int = 510  # hard context limit; 450 is the safe split point

    @property
    def samples_per_frame(self) -> int:
        """24 kHz samples a duration frame: the predictor's 2× upsample ×
        the decoder's rates × the hop (2 · 10 · 6 · 5 = 600)."""
        rate = 1
        for r in self.upsample_rates:
            rate *= r
        return 2 * rate * self.istft_hop
