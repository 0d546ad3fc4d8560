"""Functional core of the port: windows, filterbanks, STFT, spectrogram
and DMEL (single- and multi-sigma), with the specband, framed and fused
kernels behind ``impl="specband"``, ``"framed"``, ``"fused"`` and
``"auto"``."""

from dmel_tpu_torch.ops.dmel import (LOG_EPS, auto_route, default_band_map,
                                     log_mel_spectrogram, mel_spectrogram,
                                     multi_sigma_mel_spectrogram,
                                     multi_sigma_route)
from dmel_tpu_torch.ops.framed import (framed_mel_power,
                                       framed_mel_power_plain)
from dmel_tpu_torch.ops.fused import dmel_power, dmel_power_plain, pad_window
from dmel_tpu_torch.ops.mel import (hz_to_mel, mel_to_hz, melscale_fbanks,
                                    melscale_fbanks_np)
from dmel_tpu_torch.ops.spectrogram import (bucketed_window_length,
                                            next_power_of_2,
                                            optimized_window_length,
                                            spectrogram)
from dmel_tpu_torch.ops.stft import (frame_signal, num_frames,
                                     pallas_compile_hint, stft_power)
from dmel_tpu_torch.ops.window import (gaussian_window,
                                      translated_gaussian_window)

__all__ = [
    "LOG_EPS", "auto_route", "bucketed_window_length", "default_band_map",
    "dmel_power",
    "dmel_power_plain", "frame_signal", "framed_mel_power",
    "framed_mel_power_plain", "gaussian_window", "hz_to_mel",
    "log_mel_spectrogram", "mel_spectrogram", "mel_to_hz",
    "melscale_fbanks", "melscale_fbanks_np", "multi_sigma_mel_spectrogram",
    "multi_sigma_route", "next_power_of_2",
    "num_frames", "optimized_window_length", "pad_window",
    "pallas_compile_hint", "spectrogram", "stft_power",
    "translated_gaussian_window",
]
