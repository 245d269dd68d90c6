"""S3Gen: speech tokens → 24 kHz waveform (the conformer, the flow's U-Net
estimator, the HiFT vocoder) and CAMPPlus, the speaker embedder."""
