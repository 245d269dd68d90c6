"""Framework-wide TTS constants (port of tpu_audio/utils/constants.py)."""

OUTPUT_FILENAME = "tts_output"

# audio
ESPEAK_SAMPLE_RATE = 22050
BUFFER_CHUNK_SIZE = 32768
PLAYBACK_MONITOR_INTERVAL = 0.2
VOLUME_BOOST_FACTOR = 1.25
MAX_SAMPLE_VALUE = 0.98

# timing
MAX_MONITORING_DURATION = 60.0
DEFAULT_STREAMING_INTERVAL = 0.5  # seconds (Marvis)

# speed
SPEED_MIN = 0.5
SPEED_MAX = 2.0
SPEED_DEFAULT = 1.0
SPEED_STEP = 0.1

# generation
MAX_SEQUENCE_LENGTH = 2048
CLEANUP_INTERVAL = 50
SPEECH_TOKENS_PER_SECOND = 12.5  # Marvis/Mimi frame rate

# Marvis codebook quality levels
MARVIS_CODEBOOKS = {"low": 8, "medium": 16, "high": 24, "max": 32}


def streaming_interval_tokens(seconds: float) -> int:
    return int(seconds * SPEECH_TOKENS_PER_SECOND)
