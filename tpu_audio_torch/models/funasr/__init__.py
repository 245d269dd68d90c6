"""Fun-ASR: SenseVoice encoder → adaptor → Qwen3 decoder."""
