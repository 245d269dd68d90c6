"""TTS constants that Marvis needs (port of part of
tpu_audio/utils/constants.py: DEFAULT_STREAMING_INTERVAL,
SPEECH_TOKENS_PER_SECOND, MARVIS_CODEBOOKS, streaming_interval_tokens).

The rest of the JAX module (playback, speed and clean-up settings) belongs
to the API and runtime utilities, ROADMAP A18.
"""

DEFAULT_STREAMING_INTERVAL = 0.5  # seconds (Marvis)
SPEECH_TOKENS_PER_SECOND = 12.5  # Marvis/Mimi frame rate

# Marvis codebook quality levels
MARVIS_CODEBOOKS = {"low": 8, "medium": 16, "high": 24, "max": 32}


def streaming_interval_tokens(seconds: float) -> int:
    return int(seconds * SPEECH_TOKENS_PER_SECOND)
