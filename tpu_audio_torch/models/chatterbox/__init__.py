"""Chatterbox: the T3 Llama with CFG and the perceiver, the voice encoder, S3Gen."""
