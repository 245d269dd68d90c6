"""CosyVoice2: the Qwen2-0.5B speech LM, S3Gen and the S3 tokenizer."""
