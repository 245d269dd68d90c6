"""Whisper speech recognition: batched window transcription."""
