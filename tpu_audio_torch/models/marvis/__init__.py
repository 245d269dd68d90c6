"""Marvis TTS: a Llama backbone and a depth decoder over Mimi frames."""
