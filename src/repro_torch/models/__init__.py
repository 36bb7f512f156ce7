"""Models of the port: every family of the reference (the decoder-only
transformer with its MoE and MLA variants, the mamba SSM LM, the Zamba2
hybrid and the Whisper-style encoder-decoder) and their attention
backends."""
