"""Whisper model dimensions.

Loaded from a checkpoint's config.json — accepts both the OpenAI naming
(n_audio_state, ...) used by mlx-community conversions and the HF
transformers naming (d_model, ...). Reference:
package/STT/Whisper/Config/WhisperConfig.swift:9-86.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        # n_vocab 51866 (large-v3 family) carries 100 languages, 51865 has 99
        return self.n_vocab - 51765 - int(self.is_multilingual)

    @staticmethod
    def from_dict(d: dict) -> "WhisperConfig":
        if "n_audio_state" in d or "n_mels" in d:
            keys = ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head",
                    "n_audio_layer", "n_vocab", "n_text_ctx", "n_text_state",
                    "n_text_head", "n_text_layer")
            return WhisperConfig(**{k: d[k] for k in keys if k in d})
        # HF transformers naming
        return WhisperConfig(
            n_mels=d.get("num_mel_bins", 80),
            n_audio_ctx=d.get("max_source_positions", 1500),
            n_audio_state=d.get("d_model", 384),
            n_audio_head=d.get("encoder_attention_heads", 6),
            n_audio_layer=d.get("encoder_layers", 4),
            n_vocab=d.get("vocab_size", 51865),
            n_text_ctx=d.get("max_target_positions", 448),
            n_text_state=d.get("d_model", 384),
            n_text_head=d.get("decoder_attention_heads", 6),
            n_text_layer=d.get("decoder_layers", 4),
        )


# openai model-size presets, for random-weight construction in tests/benches
PRESETS = {
    "tiny": WhisperConfig(),
    "base": WhisperConfig(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                          n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": WhisperConfig(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                           n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": WhisperConfig(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                            n_text_state=1024, n_text_head=16, n_text_layer=24),
    "large-v3": WhisperConfig(n_mels=128, n_vocab=51866, n_audio_state=1280,
                              n_audio_head=20, n_audio_layer=32,
                              n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v3-turbo": WhisperConfig(n_mels=128, n_vocab=51866, n_audio_state=1280,
                                    n_audio_head=20, n_audio_layer=32,
                                    n_text_state=1280, n_text_head=20,
                                    n_text_layer=4),
}
