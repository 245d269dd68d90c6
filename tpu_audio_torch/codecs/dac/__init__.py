"""DAC: the Descript Audio Codec of OuteTTS (24 kHz, 2 codebooks)."""
