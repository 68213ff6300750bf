"""Low-precision codecs, quantizers and oracles (torch)."""
