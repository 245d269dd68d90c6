"""Whisper's whole-clip log-mel (port of tpu_audio/models/whisper/pipeline.py:
MelExtractor, _pad_frames). The seek-loop `WhisperPipeline` is not ported
yet; batch transcription is in `batch.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_audio_torch.ops import frontends
from tpu_audio_torch.ops.kernels import fused_mel

N_FRAMES = frontends.WHISPER_N_FRAMES  # 3000
HOP = frontends.WHISPER_HOP
N_FFT = frontends.WHISPER_N_FFT
CHUNK_SAMPLES = frontends.WHISPER_N_SAMPLES


class MelExtractor:
    """Whole-clip log-mel, one `fused_log_mel` launch per 30 s chunk.

    Chunks carry an n_fft/2 sample margin on each side so frame values are
    identical to a single full-clip STFT; the clip-wide max−8 clip and the
    (x+4)/4 normalisation follow (the clip is a global max in Whisper).
    """

    def __init__(self, n_mels: int, device: torch.device | str = "cpu"):
        self.n_mels = n_mels
        self.device = torch.device(device)

    def __call__(self, audio: np.ndarray,
                 padding: int = CHUNK_SAMPLES) -> torch.Tensor:
        """audio (T,) 16 kHz → normalized log-mel (total_frames, n_mels), f32
        on the extractor's device, total_frames = (T + padding) // HOP."""
        margin = N_FFT // 2
        total = len(audio) + padding
        total_frames = total // HOP
        padded = np.pad(np.asarray(audio, np.float32), (0, padding))
        padded = np.pad(padded, (margin, margin), mode="reflect")
        n_chunks = -(-total_frames // N_FRAMES)
        need = n_chunks * CHUNK_SAMPLES + 2 * margin
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        x = torch.from_numpy(padded).to(self.device)
        mels = [fused_mel.fused_log_mel(
                    x[c * CHUNK_SAMPLES: c * CHUNK_SAMPLES + CHUNK_SAMPLES + 2 * margin],
                    n_mels=self.n_mels)[:N_FRAMES]
                for c in range(n_chunks)]
        return frontends.log10_norm(torch.cat(mels)[:total_frames])


def _pad_frames(mel: torch.Tensor, n: int) -> torch.Tensor:
    if mel.shape[0] >= n:
        return mel[:n]
    return torch.nn.functional.pad(mel, (0, 0, 0, n - mel.shape[0]))
