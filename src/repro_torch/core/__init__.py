"""Core of the port: packing constants and statistics, the selection
engine, the channel model and the one-bit quantizer."""
