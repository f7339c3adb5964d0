"""Attention ops and the Hopper kernels behind them (``csrc/``)."""
