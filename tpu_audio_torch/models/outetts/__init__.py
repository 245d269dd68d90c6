"""OuteTTS: a Llama-3.2-1B LM emitting interleaved DAC codes."""
