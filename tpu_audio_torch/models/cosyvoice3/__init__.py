"""CosyVoice3: the Qwen2 LM of CosyVoice2, the DiT flow and the causal HiFT."""
