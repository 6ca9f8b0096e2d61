"""Cross-cutting utilities of the port: tracing, timing and the H100's
roofline accounting."""
