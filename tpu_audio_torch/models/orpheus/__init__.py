"""Orpheus TTS: Llama-3.2-3B LM → SNAC frames."""
