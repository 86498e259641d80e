"""WAV I/O for the port."""
