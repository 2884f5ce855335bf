"""Global constants of the VALL-E token spaces (copy of ``valle_tpu/macros.py``)."""

NUM_TEXT_TOKENS = 512
NUM_AUDIO_TOKENS = 1024  # EnCodec RVQ bins per codebook
NUM_MEL_BINS = 100  # BigVGAN-compatible mel spectrogram

NUM_SPEAKER_CLASSES = 4096  # reserved (unused by reference at runtime)
SPEAKER_EMBEDDING_DIM = 64

# Derived token ids
AUDIO_PAD_ID = NUM_AUDIO_TOKENS  # = EOS id for codebook 0
AUDIO_EOS_ID = NUM_AUDIO_TOKENS
AUDIO_BOS_ID = NUM_AUDIO_TOKENS + 1

# EnCodec 24 kHz frame rate: frame_shift = 320 / 24000 s -> 75 Hz
AUDIO_SAMPLE_RATE = 24000
AUDIO_HOP = 320
AUDIO_FRAME_RATE = AUDIO_SAMPLE_RATE // AUDIO_HOP  # 75
SAMPLE_RATE = AUDIO_SAMPLE_RATE

# BigVGAN fbank hop: 256 samples at 24 kHz -> 93.75 frames/s mel features
FBANK_HOP = 256
