"""Kokoro (StyleTTS2-style, 82M): ALBERT, the duration and prosody
predictors over masked BiLSTMs, the AdaIN decoder and the iSTFT-NSF
generator (port of tpu_audio/models/kokoro/)."""

from tpu_audio_torch.models.kokoro.config import AlbertConfig, KokoroConfig

__all__ = ["AlbertConfig", "KokoroConfig"]
