"""The S3 speech tokenizer: 16 kHz log-mel → 25 Hz FSQ speech tokens."""
