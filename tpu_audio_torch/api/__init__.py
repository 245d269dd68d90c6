"""The public API (port of tpu_audio/api/): results, the STT and TTS factories."""
