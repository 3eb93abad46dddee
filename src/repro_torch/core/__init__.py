"""Posit formats, the plain PyTorch codec and PDPU, the quantization
policy, and the paper's host references (numpy / Fraction codecs, the
discrete dot-product baselines, the hardware cost model)."""
