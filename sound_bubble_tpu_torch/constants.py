"""Physical and project constants (copy of `sound_bubble_tpu/constants.py`)."""

SPEED_OF_SOUND = 343.0  # m/s
MAX_SHIFT = 2           # max inter-mic shift in samples for alignment utils
SAMPLE_RATE = 24000     # processing rate (capture is 48 kHz, 2x downsample)
CAPTURE_RATE = 48000
CHUNK_SIZE = 192        # 8 ms @ 24 kHz
LOOKAHEAD = 96          # 4 ms @ 24 kHz
BUBBLE_RADII = (1.0, 1.5, 2.0)
