from .mfcc import compute_mfccs, frame_audio, mel_log, power_spectrum
from .reference import compute_mfccs_reference

__all__ = ["compute_mfccs", "compute_mfccs_reference", "frame_audio", "mel_log", "power_spectrum"]
