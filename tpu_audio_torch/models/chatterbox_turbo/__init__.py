"""Chatterbox Turbo: the GPT-2 T3 and the meanflow S3Gen."""
