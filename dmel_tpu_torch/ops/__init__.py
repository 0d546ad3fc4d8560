"""Functional core of the port: windows, filterbanks, STFT, spectrogram
and DMEL, with the specband kernel behind ``impl="specband"`` and
``impl="auto"``."""

from dmel_tpu_torch.ops.dmel import (LOG_EPS, auto_route,
                                     log_mel_spectrogram, mel_spectrogram)
from dmel_tpu_torch.ops.mel import (hz_to_mel, mel_to_hz, melscale_fbanks,
                                    melscale_fbanks_np)
from dmel_tpu_torch.ops.spectrogram import (bucketed_window_length,
                                            next_power_of_2,
                                            optimized_window_length,
                                            spectrogram)
from dmel_tpu_torch.ops.stft import (frame_signal, num_frames,
                                     pallas_compile_hint, stft_power)
from dmel_tpu_torch.ops.window import gaussian_window

__all__ = [
    "LOG_EPS", "auto_route", "bucketed_window_length", "frame_signal",
    "gaussian_window", "hz_to_mel", "log_mel_spectrogram",
    "mel_spectrogram", "mel_to_hz", "melscale_fbanks",
    "melscale_fbanks_np", "next_power_of_2", "num_frames",
    "optimized_window_length", "pallas_compile_hint", "spectrogram",
    "stft_power",
]
