"""Audio codecs of the port."""
