"""The public API (port of tpu_audio/api/): results and the STT factory."""
